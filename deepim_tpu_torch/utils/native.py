"""ctypes bindings for the native host-IO library (native/meshio.cpp, at
the repository's root beside both packages): the port's counterpart of
deepim_tpu/utils/native.py, which parses points.xyz files and OBJ meshes
in C++.

Build with `make -C native`.  Where the shared library is absent or does
not load, parse_obj_native returns None and load_points_xyz parses with
numpy, so callers fall back to Python parsing of the same files (the
reference's equivalent build step is lib/flow_c/setup_linux.py via
init.sh).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libdeepim_meshio.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.meshio_obj_open.restype = ctypes.c_void_p
        lib.meshio_obj_open.argtypes = [ctypes.c_char_p]
        lib.meshio_obj_counts.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.meshio_obj_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.meshio_obj_close.argtypes = [ctypes.c_void_p]
        lib.meshio_xyz_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.meshio_xyz_fill.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def parse_obj_native(path: str):
    """Native OBJ parse -> (verts (V,3), texcoords (T,2), tris (F,3),
    tri_tex (F,3), vertex_colors (V,3)|empty) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.meshio_obj_open(path.encode())
    if not handle:
        return None
    try:
        nv = ctypes.c_int()
        nt = ctypes.c_int()
        nf = ctypes.c_int()
        hc = ctypes.c_int()
        lib.meshio_obj_counts(handle, ctypes.byref(nv), ctypes.byref(nt), ctypes.byref(nf), ctypes.byref(hc))
        verts = np.empty((nv.value, 3), np.float32)
        colors = np.empty((nv.value, 3), np.float32)
        texs = np.empty((max(nt.value, 1), 2), np.float32)
        tris = np.empty((nf.value, 3), np.int32)
        tri_tex = np.empty((nf.value, 3), np.int32)
        lib.meshio_obj_fill(
            handle,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            texs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            tri_tex.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        if nt.value == 0:
            texs = np.zeros((1, 2), np.float32)
        vcols = colors if hc.value else np.zeros((0, 3), np.float32)
        return verts, texs, tris, tri_tex, vcols
    finally:
        lib.meshio_obj_close(handle)


def load_points_xyz(path: str) -> np.ndarray:
    """points.xyz loader: native fast path, numpy fallback."""
    lib = _load()
    if lib is not None:
        n = ctypes.c_int()
        if lib.meshio_xyz_count(path.encode(), ctypes.byref(n)) == 0:
            out = np.empty((n.value, 3), np.float32)
            if lib.meshio_xyz_fill(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n.value) == 0:
                return out
    return np.loadtxt(path).astype(np.float32).reshape(-1, 3)
