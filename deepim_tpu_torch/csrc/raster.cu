// Per-tile z-buffer + shading kernels of the rasterizer, for Hopper (sm_90a).
//
// Three kernels, each a translation of a Pallas TPU kernel in
// deepim_tpu/render/pallas_raster.py (what they compute, not how the TPU
// computes it):
//
//   csr_raster_kernel   replaces _csr_chunk_kernel ("slots8").  One block per
//                       work item (one 16x8 fine tile of one sample), 128
//                       threads, one per pixel.  The block walks its tile's
//                       CSR segment of pack-face units in ascending unit id;
//                       a unit's `pack` faces are consecutive global face
//                       ids, so the faces arrive in ascending face id and a
//                       strict `qi > best` test gives the TPU kernel's
//                       (max 1/z, then min face id) winner without its
//                       8-slot sublane merge.
//   csr_planes_raster_kernel
//                       replaces _csr_planes_kernel ("planes64").  The same
//                       block shape and face walk as csr_raster_kernel, but
//                       it reads the raw corner pack (rasterizer.
//                       build_raw_pack rows) and derives each face's planes
//                       while staging it: one thread per staged face, the
//                       25 record values of build_face_records computed
//                       with the same operations in the same order, each
//                       rounded on its own, and a correctly rounded
//                       reciprocal (__frcp_rn; torch's 1.0 / t is an IEEE
//                       division).  Its planes are therefore bit-identical
//                       to the record table, and its output to
//                       csr_raster_kernel's on the same scene.
//   tile_raster_kernel  replaces _tile_kernel (dense path).  One block per
//                       work item (one tile_h x tile_w tile), one thread per
//                       pixel, looping over the tile's counts[w] face ids
//                       from the dense (W, K) list in draw order, same
//                       strict test.
//
// Face records are the 32-float rows built by rasterizer.build_face_records
// (lane layout in pallas_raster.py:19-40): anchor u0 v0, edge planes
// (A0 B0 ar) (A1 B1) (A2 B2), 1/z plane (Qa Qb q0), clamp [qmin, qmax],
// fid, pad, r*q / g*q / b*q planes.  Blocks stage records in shared memory a
// chunk at a time; every thread then reads the same record word (a shared
// memory broadcast, no bank conflicts).
//
// What bounds them on an H100: the work is one evaluation of ~22 fp32
// operations per (face, pixel) pair of the binned lists, reading 128 bytes
// of record per face from device memory once per tile that face is binned
// to.  At the main path's shapes both the byte and the operation bound are
// tens of microseconds, so what limits these simple kernels in practice is
// latency: the per-face loop is serial inside a block, and a 16x8 tile only
// has 4 warps.  The design keeps every block's face loop to the faces its
// own tile needs (exact CSR segments / per-tile counts) and stages records
// so each word is read from device memory once per block.  Faster designs
// (several tiles per block, split face lists) are later work.
// csr_planes_raster_kernel reads 80 bytes of raw row (20 lanes, five
// 16-byte loads) instead of a 128-byte record per face-tile pair and adds
// ~75 fp32 operations of plane derivation per pair, against 128 x 22 for
// the pair's evaluation: the same bound, and the same latency limit.
// Speed is later work for it too.
//
// Arithmetic order: every plane is evaluated as ((a*dx) + (b*dy)) + c with
// dx = px - u0, each operation rounded on its own with the __fmul_rn /
// __fadd_rn / __fsub_rn intrinsics, which nvcc never contracts into FMAs.
// That is the order of pallas_raster.py:88-99 and :180-194 and of the plain
// PyTorch twins in render/raster_kernels.py, so kernel and twin agree bit
// for bit.  (The alternative, -fmad=false, would change the whole file.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 32;            // floats per face record
constexpr float kNeg = -1e30f;      // empty z-buffer / invalid edge constant
constexpr float kBig = 1e30f;       // "no face" id
constexpr int kCsrPixels = 128;     // 16x8 fine tile
constexpr int kCsrStage = 192;      // faces staged per chunk (24 KB)
constexpr int kTileStage = 128;     // faces staged per chunk (16 KB)

__device__ __forceinline__ float plane3(const float* rc, int j, float dx, float dy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(rc[j], dx), __fmul_rn(rc[j + 1], dy)), rc[j + 2]);
}

__device__ __forceinline__ float plane2(const float* rc, int j, float dx, float dy) {
  return __fadd_rn(__fmul_rn(rc[j], dx), __fmul_rn(rc[j + 1], dy));
}

struct Frag {
  float q, fid, r, g, b;
};

// Evaluate one face record at (px, py) and keep it when it covers the pixel
// and is strictly nearer (larger interpolated 1/z) than the current winner.
__device__ __forceinline__ void shade_face(const float* rc, float px, float py, Frag& best) {
  const float dx = __fsub_rn(px, rc[0]);
  const float dy = __fsub_rn(py, rc[1]);
  const float e0 = plane3(rc, 2, dx, dy);
  const float e1 = plane2(rc, 5, dx, dy);
  const float e2 = plane2(rc, 7, dx, dy);
  const bool inside = fminf(e0, fminf(e1, e2)) >= 0.0f;
  const float qi = fminf(fmaxf(plane3(rc, 9, dx, dy), rc[12]), rc[13]);
  if (inside && qi > best.q) {
    best.q = qi;
    best.fid = rc[14];
    best.r = plane3(rc, 16, dx, dy);
    best.g = plane3(rc, 19, dx, dy);
    best.b = plane3(rc, 22, dx, dy);
  }
}

__global__ void __launch_bounds__(kCsrPixels) csr_raster_kernel(
    const float* __restrict__ records,      // (N, 32)
    const int* __restrict__ sorted_unit,    // flat CSR unit ids
    const int* __restrict__ seg_start,      // (W,) first unit slot of the tile
    const int* __restrict__ seg_count,      // (W,) units in the tile
    const int* __restrict__ tile_xy,        // (W, 2) pixel origin (x0, y0)
    const int* __restrict__ unit_base,      // (W,) sample * units per sample
    float* __restrict__ out,                // (W, 5, 128) [q, fid, rq, gq, bq]
    int pack, int tile_w) {
  __shared__ float srec[kCsrStage * kRec];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)(tile_xy[2 * w] + tid % tile_w);
  const float py = (float)(tile_xy[2 * w + 1] + tid / tile_w);
  const int n_faces = seg_count[w] * pack;
  const int start = seg_start[w];
  const int ubase = unit_base[w];
  Frag best = {kNeg, kBig, 0.0f, 0.0f, 0.0f};

  for (int base = 0; base < n_faces; base += kCsrStage) {
    const int n = min(kCsrStage, n_faces - base);
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < n * kRec; i += kCsrPixels) {
      const int lf = base + i / kRec;  // face slot within the segment
      const int unit = sorted_unit[start + lf / pack];
      const int gf = (ubase + unit) * pack + lf % pack;
      srec[i] = records[(size_t)gf * kRec + (i % kRec)];
    }
    __syncthreads();
    for (int f = 0; f < n; ++f) shade_face(srec + f * kRec, px, py, best);
  }
  float* o = out + (size_t)w * 5 * kCsrPixels + tid;
  o[0 * kCsrPixels] = best.q;
  o[1 * kCsrPixels] = best.fid;
  o[2 * kCsrPixels] = best.r;
  o[3 * kCsrPixels] = best.g;
  o[4 * kCsrPixels] = best.b;
}

// build_face_records' attribute plane of corner values (w0, w1, w2):
// a = (d1 (v2 - v0) - d2 (v1 - v0)) inv, b = (d2 (u1 - u0) - d1 (u2 - u0)) inv.
__device__ __forceinline__ void attr_plane(float w0, float w1, float w2, float du1, float du2,
                                           float dv1, float dv2, float inv, float* dst) {
  const float d1 = __fsub_rn(w1, w0);
  const float d2 = __fsub_rn(w2, w0);
  dst[0] = __fmul_rn(__fsub_rn(__fmul_rn(d1, dv2), __fmul_rn(d2, dv1)), inv);
  dst[1] = __fmul_rn(__fsub_rn(__fmul_rn(d2, du1), __fmul_rn(d1, du2)), inv);
  dst[2] = w0;
}

// One raw corner-pack row -> the record lanes shade_face reads (0..24),
// exactly as rasterizer.build_face_records computes them.  Raw lanes:
// [0:3] u, [3:6] v, [6:9] 1/z, [9:18] corner colours (corner-major),
// [18] face id, [19] validity.
__device__ __forceinline__ void derive_planes(const float4* __restrict__ row, float* rc) {
  float r[20];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float4 x = row[i];
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
  const float u0 = r[0], u1 = r[1], u2 = r[2];
  const float v0 = r[3], v1 = r[4], v2 = r[5];
  const float q0 = r[6], q1 = r[7], q2 = r[8];
  const float du1 = __fsub_rn(u1, u0), du2 = __fsub_rn(u2, u0);
  const float dv1 = __fsub_rn(v1, v0), dv2 = __fsub_rn(v2, v0);
  const float area = __fsub_rn(__fmul_rn(du1, dv2), __fmul_rn(dv1, du2));
  const bool ok = r[19] > 0.0f && fabsf(area) > 1e-12f;
  const float s = ok ? (area > 0.0f ? 1.0f : (area < 0.0f ? -1.0f : 0.0f)) : 0.0f;
  const float inv = __frcp_rn(ok ? area : 1.0f);
  rc[0] = u0;
  rc[1] = v0;
  rc[2] = __fmul_rn(-__fsub_rn(v2, v1), s);
  rc[3] = __fmul_rn(__fsub_rn(u2, u1), s);
  rc[4] = ok ? fabsf(area) : kNeg;
  rc[5] = __fmul_rn(-__fsub_rn(v0, v2), s);
  rc[6] = __fmul_rn(__fsub_rn(u0, u2), s);
  rc[7] = __fmul_rn(-__fsub_rn(v1, v0), s);
  rc[8] = __fmul_rn(__fsub_rn(u1, u0), s);
  attr_plane(q0, q1, q2, du1, du2, dv1, dv2, inv, rc + 9);
  rc[12] = fminf(q0, fminf(q1, q2));
  rc[13] = fmaxf(q0, fmaxf(q1, q2));
  rc[14] = r[18];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    attr_plane(__fmul_rn(r[9 + c], q0), __fmul_rn(r[12 + c], q1), __fmul_rn(r[15 + c], q2),
               du1, du2, dv1, dv2, inv, rc + 16 + 3 * c);
  }
}

__global__ void __launch_bounds__(kCsrPixels) csr_planes_raster_kernel(
    const float* __restrict__ raw,          // (N, 32) raw corner pack
    const int* __restrict__ sorted_unit,    // flat CSR unit ids
    const int* __restrict__ seg_start,      // (W,) first unit slot of the tile
    const int* __restrict__ seg_count,      // (W,) units in the tile
    const int* __restrict__ tile_xy,        // (W, 2) pixel origin (x0, y0)
    const int* __restrict__ unit_base,      // (W,) sample * units per sample
    float* __restrict__ out,                // (W, 5, 128) [q, fid, rq, gq, bq]
    int pack, int tile_w) {
  // Derived planes, kPlaneStride floats per face: the odd stride keeps the
  // per-thread row writes free of bank conflicts; the shading loop reads
  // one word for all threads (a broadcast).
  constexpr int kPlaneStride = 25;
  __shared__ float splanes[kCsrStage * kPlaneStride];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)(tile_xy[2 * w] + tid % tile_w);
  const float py = (float)(tile_xy[2 * w + 1] + tid / tile_w);
  const int n_faces = seg_count[w] * pack;
  const int start = seg_start[w];
  const int ubase = unit_base[w];
  Frag best = {kNeg, kBig, 0.0f, 0.0f, 0.0f};

  for (int base = 0; base < n_faces; base += kCsrStage) {
    const int n = min(kCsrStage, n_faces - base);
    __syncthreads();  // previous chunk fully consumed
    for (int f = tid; f < n; f += kCsrPixels) {
      const int lf = base + f;  // face slot within the segment
      const int unit = sorted_unit[start + lf / pack];
      const int gf = (ubase + unit) * pack + lf % pack;
      derive_planes(reinterpret_cast<const float4*>(raw + (size_t)gf * kRec),
                    splanes + f * kPlaneStride);
    }
    __syncthreads();
    for (int f = 0; f < n; ++f) shade_face(splanes + f * kPlaneStride, px, py, best);
  }
  float* o = out + (size_t)w * 5 * kCsrPixels + tid;
  o[0 * kCsrPixels] = best.q;
  o[1 * kCsrPixels] = best.fid;
  o[2 * kCsrPixels] = best.r;
  o[3 * kCsrPixels] = best.g;
  o[4 * kCsrPixels] = best.b;
}

__global__ void __launch_bounds__(1024) tile_raster_kernel(
    const float* __restrict__ records,      // (N, 32)
    const int* __restrict__ tf_global,      // (W, K) global face ids, -1 padded
    const int* __restrict__ counts,         // (W,)
    const int* __restrict__ tile_xy,        // (W, 2) pixel origin (x0, y0)
    float* __restrict__ out,                // (W, 4, P) [zq, rq, gq, bq]
    int k_cap, int tile_w) {
  __shared__ float srec[kTileStage * kRec];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = blockDim.x;
  const float px = (float)(tile_xy[2 * w] + tid % tile_w);
  const float py = (float)(tile_xy[2 * w + 1] + tid / tile_w);
  const int cnt = counts[w];
  const int* ids = tf_global + (size_t)w * k_cap;
  Frag best = {kNeg, kBig, 0.0f, 0.0f, 0.0f};

  for (int base = 0; base < cnt; base += kTileStage) {
    const int n = min(kTileStage, cnt - base);
    __syncthreads();
    for (int i = tid; i < n * kRec; i += p) {
      const int gf = ids[base + i / kRec];
      srec[i] = records[(size_t)gf * kRec + (i % kRec)];
    }
    __syncthreads();
    for (int f = 0; f < n; ++f) shade_face(srec + f * kRec, px, py, best);
  }
  float* o = out + (size_t)w * 4 * p + tid;
  o[0 * p] = best.q;
  o[1 * p] = best.r;
  o[2 * p] = best.g;
  o[3 * p] = best.b;
}

}  // namespace

extern "C" int csr_raster_launch(const void* records, const void* sorted_unit,
                                 const void* seg_start, const void* seg_count,
                                 const void* tile_xy, const void* unit_base, void* out,
                                 int w_items, int pack, int tile_w, void* stream) {
  if (w_items > 0) {
    csr_raster_kernel<<<w_items, kCsrPixels, 0, (cudaStream_t)stream>>>(
        (const float*)records, (const int*)sorted_unit, (const int*)seg_start,
        (const int*)seg_count, (const int*)tile_xy, (const int*)unit_base, (float*)out,
        pack, tile_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int csr_planes_raster_launch(const void* raw, const void* sorted_unit,
                                        const void* seg_start, const void* seg_count,
                                        const void* tile_xy, const void* unit_base, void* out,
                                        int w_items, int pack, int tile_w, void* stream) {
  if (w_items > 0) {
    csr_planes_raster_kernel<<<w_items, kCsrPixels, 0, (cudaStream_t)stream>>>(
        (const float*)raw, (const int*)sorted_unit, (const int*)seg_start,
        (const int*)seg_count, (const int*)tile_xy, (const int*)unit_base, (float*)out,
        pack, tile_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int tile_raster_launch(const void* records, const void* tf_global,
                                  const void* counts, const void* tile_xy, void* out,
                                  int w_items, int k_cap, int tile_pixels, int tile_w,
                                  void* stream) {
  if (w_items > 0) {
    tile_raster_kernel<<<w_items, tile_pixels, 0, (cudaStream_t)stream>>>(
        (const float*)records, (const int*)tf_global, (const int*)counts,
        (const int*)tile_xy, (float*)out, k_cap, tile_w);
  }
  return (int)cudaGetLastError();
}
