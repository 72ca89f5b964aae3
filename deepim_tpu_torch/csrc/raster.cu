// Kernels of the rasterizer, for Hopper (sm_90a): per-tile z-buffer +
// shading, and the CSR binning (further below).
//
// Three z-buffer kernels, each a translation of a Pallas TPU kernel in
// deepim_tpu/render/pallas_raster.py (what they compute, not how the TPU
// computes it):
//
//   csr_raster_kernel   replaces _csr_chunk_kernel ("slots8").  A work item is
//                       one 16x8 fine tile of one sample with its CSR
//                       segment of pack-face units in ascending unit id; a
//                       unit's `pack` faces are consecutive global face ids
//                       (rows of the record table), so a list's rows
//                       ascend.  Per pixel the largest clamped 1/z wins,
//                       ties go to the smallest row: the TPU kernel's (max
//                       1/z, then min face id) winner without its 8-slot
//                       sublane merge.
//   csr_planes_raster_kernel
//                       replaces _csr_planes_kernel ("planes64").  The same
//                       kernel body, but it reads the raw corner pack
//                       (rasterizer.build_raw_pack rows) and derives each
//                       face's planes in registers: the record values of
//                       build_face_records computed with the same
//                       operations in the same order, each rounded on its
//                       own, and a correctly rounded reciprocal (__frcp_rn;
//                       torch's 1.0 / t is an IEEE division).  Its planes
//                       are therefore bit-identical to the record table,
//                       and its output to csr_raster_kernel's on the same
//                       scene.
//   tile_raster_kernel  replaces _tile_kernel (dense path).  A work item is
//                       one tile_h x tile_w tile (a multiple of 32 pixels, at
//                       most 1,024) with its counts[w] global face ids from
//                       row w of the dense (W, K) list, in draw order.  Per
//                       pixel the largest clamped 1/z wins, ties go to the
//                       first face of the list (the TPU kernel's strict
//                       test), whatever the order of the ids.
//
// Face records are the 32-float rows built by rasterizer.build_face_records
// (lane layout in pallas_raster.py:19-40): anchor u0 v0, edge planes
// (A0 B0 ar) (A1 B1) (A2 B2), 1/z plane (Qa Qb q0), clamp [qmin, qmax],
// fid, pad, r*q / g*q / b*q planes.  Records are finite numbers.
//
// What bounds the two CSR kernels on an H100.  The work is one evaluation
// of ~22 fp32 operations per (face, pixel) pair of the binned lists, and
// 128 (80 for the raw pack) bytes of record per face from device memory,
// once per tile the face is binned to.  At the main path's shapes (2,048
// work items, a third of them non-empty, ~190 faces each, 464 at most)
// both the byte and the operation bound are a few microseconds.  What the
// kernels cost in practice is issue slots and latency: a face of a fine
// mesh covers half a pixel of a tile on average, so a block that gives
// every pixel a thread and walks the faces spends nearly all its issue
// slots proving that faces miss pixels, one block's serial loop over its
// longest list sets the launch's time, and ~1,400 empty work items queue
// for a block each.  The design turns the loop round:
//
//   1. One thread per face.  A block of 256 threads takes a work item;
//      thread t reads the planes of faces t, t + 256, ... of the tile's list
//      into registers with 16-byte loads (the record's first 28 lanes, or the
//      raw row, from which it derives them), so no record is read by more
//      than one thread and nothing waits on a block-wide staging step.
//   2. Cull before touching pixels, exactly.  The thread evaluates each of
//      the face's edge planes once for each of the tile's 8 blocks of 16
//      pixels, at the corner pixel of that rectangle where the plane is
//      largest (the signs of its two coefficients pick the
//      corner), with the operations the per-pixel test uses.  Each operation
//      is rounded on its own and rounding is monotone, so the plane at any
//      pixel of the rectangle is <= its value at that corner: one negative
//      maximum proves that no pixel of the rectangle passes the inside test.
//      A face keeps 1.5 to 2 of its 8 blocks on average.
//   3. Spread what is left over the warp.  Faces keep unequal numbers of
//      blocks, and a warp is as slow as its worst lane.  So each lane leaves
//      its face's planes in shared memory and enters its (face, block) pairs
//      into the warp's queue at a prefix sum of the counts; lane i then
//      takes pair i, i + 32, ...  A pair's 16 pixels are tested without a
//      branch (a 4x4 block unrolled, the products with dx shared by a
//      column and those with dy by a row), and only covered pixels go on.
//   4. A z-buffer of 64-bit keys in shared memory.  A covered pixel gets
//      atomicMax(order-preserving bits of the clamped 1/z << 32 | ~face
//      row): the largest 1/z wins and, among equals, the smallest face row,
//      which is the twin's first-in-list rule since a list's rows ascend.
//      The order of the atomics does not matter, so the result is
//      deterministic.  (-0 orders below +0 here, unlike a float compare; 1/z
//      of a valid face is positive.)  When the list is done, thread p reads
//      pixel p's winner, loads that one face again and shades it.
//   5. A grid of resident blocks.  The launch has as many blocks as the card
//      holds at once; block b walks items b, 2G-1-b, 2G+b, ... of the work
//      list, which is sorted longest first, with the next item's face count
//      already loaded, so an empty item costs a few stores instead of a
//      block.
//
// The dense kernel meets both ends of that regime: a cube face fills whole
// tiles of up to 1,024 pixels from a list of a handful of faces, a
// 1,280-face sphere leaves lists of 150 to 220 faces a few pixels wide,
// some 10 of them over a 16-pixel block and up to 23 at its limb.  An item is a short chain of phases,
// each waiting on latency or on the instruction rate, so each is spread over
// the whole block of 512 threads, and covered pixels are many, so they get
// no atomics:
//
//   1. Resident blocks walk the count-sorted work list in the same snake; an
//      empty item costs the 16-byte stores of its rows.
//   2. Faces on threads for the cull.  A pass takes up to 256 faces of the
//      list; the block's threads split into as many parts as the pass leaves
//      room for (2 for 256 faces, 64 for 8), and thread (face, part) tests
//      the face against that part's share of the tile's 16-pixel blocks (up
//      to 64 of them: 4 x 4 pixels where the tile's sides allow it) by the
//      same exact corner-maximum rule.  Along a row of blocks the rule's dy
//      products stay and the dx products step, so a test is one product and
//      two sums an edge, with no branch and nothing carried from test to
//      test.  So six tile-filling faces keep 384 threads busy, not six.
//   3. The live (face, block) bits are transposed with 32-bit atomic ORs in
//      shared memory into one list a block: a bit a face, in list order (two
//      copies, so that a pass clears one while it fills the other).  Part 0
//      leaves the face's planes and row in a stash.
//   4. Pixels on threads for the z-test.  Eight neighbouring threads own the
//      16 pixels of a cull block, two each, for the whole item.  A thread
//      walks its block's list in list order with the TPU kernel's strict
//      test and keeps the winner's 1/z and row in registers: the first of
//      equal faces stays, whatever the order of the ids, and there is no
//      z-buffer in memory.  When the list is done it loads its winners'
//      colour planes and shades.
//
// (A first version of this kernel kept the CSR design: a queue of (face,
// block) pairs over the block and the 64-bit atomic-max z-buffer with the
// list position in the key.  With 6 to 18 covered pixels a face instead of
// half a pixel, the 64-bit shared-memory atomics, compare-and-swap loops on
// this card, took most of its time.)
//
// Arithmetic order: every plane is evaluated as ((a*dx) + (b*dy)) + c with
// dx = px - u0, each operation rounded on its own with the __fmul_rn /
// __fadd_rn / __fsub_rn intrinsics, which nvcc never contracts into FMAs.
// That is the order of pallas_raster.py:88-99 and :180-194 and of the plain
// PyTorch twins in render/raster_kernels.py, so kernel and twin agree bit
// for bit.  (The alternative, -fmad=false, would change the whole file.)
//
// RASTER_ABLATE (a compile-time value, 0 in every build the package
// makes): 1 switches the cull off (every face at every pixel of its tile,
// the same output), so that tools/raster_ablation.py can time what it buys.
//
// The CSR binning kernels (csr_bin_count, csr_bin_offsets, csr_bin_scatter,
// csr_bin_order; launched together by csr_bin_launch) replace no Pallas
// kernel: they stand where the JAX package's XLA binning stood
// (rasterizer.bin_faces_csr, its plain version), in place of a torch sort
// of one key per budget slot.  They build the same CSR segments of (tile,
// pack unit) pairs over the fine tiles: per sample, offsets and counts of
// every tile, the dropped-pair count, and each tile's units in ascending
// order.  What bounds them: reading the units' projected corners (~16 MB
// at batch 32 of a 21k-face bank) and writing the real pairs (~0.7 MB), a
// few microseconds at 3.35 TB/s, so launch latency and the atomics on the
// tiles many units share set the pace.  The work follows the real pairs
// and the tiles, never the budget (a padded bank's budget was ~700x its
// real pairs):
//
//   1. count    one thread a (sample, unit) forms the union bbox of the
//               unit's valid on-screen faces with bin_faces_csr's float32
//               operations (floor of an IEEE division by the tile side,
//               clamped; the same off-screen test), keeps the first S_u
//               tiles of the bbox in row-major order (S_u from the per-run
//               caps of the budget) and adds one to each kept tile's count,
//               and what it drops to the sample's dropped count (64-bit
//               atomics in device memory);
//   2. offsets  one block a sample: the exclusive prefix sum of its tiles'
//               counts, also as a cursor for step 3;
//   3. scatter  the same thread again: each kept tile's cursor gives the
//               unit a slot in that tile's segment (atomics, so the order
//               within a segment is the atomics' order);
//   4. order    one warp a tile puts its segment in ascending unit order:
//               a bitonic network in the warp's shared memory up to 2,048
//               units, the same network in device memory beyond (correct,
//               slower; the main path's longest segments hold 350 to 1,300
//               units).  Unit ids in a segment are distinct, so the result
//               does not depend on the order of step 3's atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RASTER_ABLATE
#define RASTER_ABLATE 0
#endif

namespace {

constexpr int kAblate = RASTER_ABLATE;
constexpr int kRec = 32;            // floats per face record
constexpr int kPlanes = 28;         // record lanes a kernel reads (0..24), in 16-byte units
constexpr float kNeg = -1e30f;      // empty z-buffer / invalid edge constant
constexpr float kBig = 1e30f;       // "no face" id
constexpr int kCsrPixels = 128;     // 16x8 fine tile
constexpr int kCsrThreads = 256;    // CSR block: one face per thread and pass
constexpr int kCullBlocks = 8;      // 16-pixel cull blocks of a CSR tile
constexpr int kStash = 20;          // floats a face keeps in its warp's stash (5 x 16 bytes: no bank conflicts)
constexpr int kTileThreads = 512;   // dense block
constexpr int kTilePass = 256;      // dense: faces culled per pass
constexpr int kTileMaxPixels = 1024;
constexpr int kTileMaxBlocks = kTileMaxPixels / 16;  // 16-pixel cull blocks of a dense tile
static_assert(kTilePass % 32 == 0 && 2 * kTilePass <= kTileThreads, "a thread culls at most 32 of a tile's 64 blocks");

// (a*dx) + (b*dy), each operation rounded on its own.
__device__ __forceinline__ float plane2(float a, float b, float dx, float dy) {
  return __fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy));
}

__device__ __forceinline__ float plane3(float a, float b, float c, float dx, float dy) {
  return __fadd_rn(plane2(a, b, dx, dy), c);
}

struct Frag {
  float q, fid, r, g, b;
};

// ---- The CSR kernels: one thread per face, scattering into a z-buffer ----
// (cull_block_shape, may_cover's rule and stash_face serve the dense kernel too)

// Pixels x_lo..x_hi by y_lo..y_hi, bounds included.
struct Rect {
  float x_lo, x_hi, y_lo, y_hi;
};

// plane2 at the pixel of the rectangle where it is largest: every
// operation is rounded on its own and rounding is monotone, so no pixel of
// the rectangle gives more.
__device__ __forceinline__ float plane2_max(float a, float b, float u0, float v0, const Rect& r) {
  const float dx = __fsub_rn(a >= 0.0f ? r.x_hi : r.x_lo, u0);
  const float dy = __fsub_rn(b >= 0.0f ? r.y_hi : r.y_lo, v0);
  return plane2(a, b, dx, dy);
}

// False only when the face (planes rc, record lane layout) covers no pixel
// of the rectangle: one of its edge planes is negative even where it is
// largest.
__device__ __forceinline__ bool may_cover(const float* rc, const Rect& r) {
  if constexpr (kAblate == 1) return true;
  const float e0 = __fadd_rn(plane2_max(rc[2], rc[3], rc[0], rc[1], r), rc[4]);
  const float e1 = plane2_max(rc[5], rc[6], rc[0], rc[1], r);
  const float e2 = plane2_max(rc[7], rc[8], rc[0], rc[1], r);
  return !(e0 < 0.0f) && !(e1 < 0.0f) && !(e2 < 0.0f);
}

// The cull block of a tile_w x tile_h tile whose pixel count is a multiple
// of 32: bw x bh = 16 pixels with bw dividing tile_w and bh dividing tile_h,
// 4 x 4 where both sides allow it, else as tall as 16 / bw must be.
struct BlockShape {
  int bw, bh;
};

__host__ __device__ inline BlockShape cull_block_shape(int tile_w, int tile_h) {
  int bh = 1;
  while (bh < 4 && tile_h % (2 * bh) == 0) bh *= 2;
  int bw = 16 / bh;
  while (tile_w % bw) bw /= 2;
  return {bw, 16 / bw};
}

// A CSR tile of tile_w x (128 / tile_w) pixels (tile_w a power of two) as 8
// cull blocks, block k at column k % (tile_w / bw), row k / (tile_w / bw) of
// the block grid.
struct CullGrid {
  int bw, bh, col_mask, row_shift;
};

__device__ __forceinline__ CullGrid cull_grid(int tile_w) {
  const BlockShape b = cull_block_shape(tile_w, kCsrPixels / tile_w);
  const int per_row = tile_w / b.bw;
  return {b.bw, b.bh, per_row - 1, __ffs(per_row) - 1};
}

// A z-buffer entry: the clamped 1/z as order-preserving bits above the
// complement of the global face row, so that an unsigned max keeps the
// largest 1/z and, among equals, the smallest face row.  0 is "no face".
__device__ __forceinline__ unsigned long long zkey(float q, unsigned gf) {
  unsigned b = __float_as_uint(q);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)~gf;
}

__device__ __forceinline__ float zkey_q(unsigned long long key) {
  const unsigned b = (unsigned)(key >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// One face at the pixels of one cull block (origin (x0 + cx, y0 + cy), bw x
// bh = 16 pixels; a compile-time kBw x kBh unrolls the loops).  The inside
// test runs over all 16 pixels without a branch, exactly as the per-pixel
// loop of the twin computes it: ((a*dx) + (b*dy)) + c, where a column of
// pixels shares the products with dx and a row those with dy.  The few
// covered pixels then get their clamped 1/z and enter the z-buffer.
template <int kBw, int kBh>
__device__ __forceinline__ void scatter_block(const float* rc, unsigned gf, int x0, int cx, int y0,
                                              int cy, int bw, int bh, int tile_w,
                                              unsigned long long* zbuf) {
  constexpr int kCols = kBw ? kBw : 1;
  float a0[kCols], a1[kCols], a2[kCols];
  if constexpr (kBw != 0) {
    bw = kBw;
    bh = kBh;
#pragma unroll
    for (int c = 0; c < kBw; ++c) {
      const float dx = __fsub_rn((float)(x0 + cx + c), rc[0]);
      a0[c] = __fmul_rn(rc[2], dx);
      a1[c] = __fmul_rn(rc[5], dx);
      a2[c] = __fmul_rn(rc[7], dx);
    }
  }
  unsigned covered = 0;  // bit r * bw + c
#pragma unroll
  for (int r = 0; r < bh; ++r) {
    const float dy = __fsub_rn((float)(y0 + cy + r), rc[1]);
    const float t0 = __fmul_rn(rc[3], dy), t1 = __fmul_rn(rc[6], dy), t2 = __fmul_rn(rc[8], dy);
#pragma unroll
    for (int c = 0; c < bw; ++c) {
      const int i = kBw ? c : 0;
      if constexpr (kBw == 0) {
        const float dx = __fsub_rn((float)(x0 + cx + c), rc[0]);
        a0[0] = __fmul_rn(rc[2], dx);
        a1[0] = __fmul_rn(rc[5], dx);
        a2[0] = __fmul_rn(rc[7], dx);
      }
      const float e0 = __fadd_rn(__fadd_rn(a0[i], t0), rc[4]);
      const float e1 = __fadd_rn(a1[i], t1);
      const float e2 = __fadd_rn(a2[i], t2);
      covered |= (fminf(e0, fminf(e1, e2)) >= 0.0f ? 1u : 0u) << (r * bw + c);
    }
  }
  while (covered) {
    const int i = __ffs(covered) - 1;
    covered &= covered - 1;
    const int c = cx + i % bw, r = cy + i / bw;
    const float dx = __fsub_rn((float)(x0 + c), rc[0]);
    const float dy = __fsub_rn((float)(y0 + r), rc[1]);
    const float qi = fminf(fmaxf(plane3(rc[9], rc[10], rc[11], dx, dy), rc[12]), rc[13]);
    if (qi > kNeg) atomicMax(zbuf + r * tile_w + c, zkey(qi, gf));
  }
}

// A face's planes rc[0..13] and an id (its row, for the CSR kernels' zkey)
// into a stash slot of kStash floats.
__device__ __forceinline__ void stash_face(float* slot, const float* rc, unsigned id) {
  float4* s = reinterpret_cast<float4*>(slot);
  s[0] = make_float4(rc[0], rc[1], rc[2], rc[3]);
  s[1] = make_float4(rc[4], rc[5], rc[6], rc[7]);
  s[2] = make_float4(rc[8], rc[9], rc[10], rc[11]);
  s[3] = make_float4(rc[12], rc[13], __uint_as_float(id), 0.0f);
}

// One face against the 8 blocks of one tile.  Bit k of the result is set
// when block k may hold a covered pixel.
__device__ __forceinline__ unsigned live_blocks(const float* rc, int x0, int y0, const CullGrid& grid) {
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kCullBlocks; ++k) {
    const int bx = x0 + (k & grid.col_mask) * grid.bw, by = y0 + (k >> grid.row_shift) * grid.bh;
    const Rect block = {(float)bx, (float)(bx + grid.bw - 1), (float)by, (float)(by + grid.bh - 1)};
    if (may_cover(rc, block)) live |= 1u << k;
  }
  return live;
}

// A warp's 32 faces (planes rc[0..13] and face row gf of each lane; `live`
// from live_blocks, 0 for a lane without a face) into the z-buffer.  A
// face keeps 1.5 of its 8 blocks on average but some keep most, so the
// (face, block) pairs are first spread evenly over the lanes: every lane
// leaves its planes in the warp's stash and enters its pairs into the
// warp's queue at the prefix sum of the counts, then lane i takes pair i,
// i + 32, ... with that face's planes from the stash.  All 32 lanes call it
// together; `stash` and `queue` are the warp's own.
__device__ __forceinline__ void scatter_warp(const float* rc, unsigned gf, unsigned live, int x0, int y0,
                                             int tile_w, const CullGrid& grid, float* stash,
                                             unsigned char* queue, unsigned long long* zbuf) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (live) stash_face(stash + lane * kStash, rc, gf);
  const int count = __popc(live);
  int end = count;  // inclusive prefix sum over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int below = __shfl_up_sync(kAll, end, d);
    if (lane >= d) end += below;
  }
  const int total = __shfl_sync(kAll, end, 31);
  for (int at = end - count; live; live &= live - 1, ++at) {
    queue[at] = (unsigned char)((lane << 3) | (__ffs(live) - 1));
  }
  __syncwarp();
  for (int base = 0; base < total; base += 32) {
    const bool on = base + lane < total;
    if (on) {
      const int pair = queue[base + lane];
      const float4* face = reinterpret_cast<const float4*>(stash + (pair >> 3) * kStash);
      const float4 a = face[0], b = face[1], c = face[2], d = face[3];
      const float planes[14] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x, d.y};
      const unsigned row = __float_as_uint(d.z);
      const int k = pair & 7;
      const int cx = (k & grid.col_mask) * grid.bw, cy = (k >> grid.row_shift) * grid.bh;
      if (grid.bw == 4) {
        scatter_block<4, 4>(planes, row, x0, cx, y0, cy, 4, 4, tile_w, zbuf);
      } else {
        scatter_block<0, 0>(planes, row, x0, cx, y0, cy, grid.bw, grid.bh, tile_w, zbuf);
      }
    }
  }
  __syncwarp();  // the stash and the queue are free again
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

// One raw corner-pack row (r: its 20 used lanes) -> the record lanes 0..24,
// exactly as rasterizer.build_face_records computes them.  Raw lanes:
// [0:3] u, [3:6] v, [6:9] 1/z, [9:18] corner colours (corner-major),
// [18] face id, [19] validity.
__device__ __forceinline__ void derive_planes(const float* r, float* rc) {
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

// Face gf's planes into registers with 16-byte loads: record lanes 0..27 of
// the record table, or (kRaw) derived from lanes 0..19 of the raw pack.
template <bool kRaw>
__device__ __forceinline__ void load_planes(const float* __restrict__ table, unsigned gf, float* rc) {
  const float4* src = reinterpret_cast<const float4*>(table + (size_t)gf * kRec);
  float r[kRaw ? 20 : 1];
#pragma unroll
  for (int i = 0; i < (kRaw ? 5 : kPlanes / 4); ++i) {
    const float4 x = __ldg(src + i);
    float* dst = kRaw ? r : rc;
    dst[4 * i] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
  if constexpr (kRaw) derive_planes(r, rc);
}

// Block b of G takes the work items b, 2G-1-b, 2G+b, ... (a snake over the
// list, which is sorted by face count, longest first), so the block that
// starts on the longest list goes on with the shortest.
__device__ __forceinline__ int snake_item(int round) {
  const int b = (round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return round * gridDim.x + b;
}

template <bool kRaw>
__device__ __forceinline__ void csr_kernel_body(
    const float* __restrict__ table, const int* __restrict__ sorted_unit,
    const int* __restrict__ seg_start, const int* __restrict__ seg_count,
    const int* __restrict__ tile_xy, const int* __restrict__ unit_base, float* __restrict__ out,
    int w_items, int pack, int tile_w) {
  __shared__ unsigned long long zbuf[kCsrPixels];
  __shared__ __align__(16) float stash[kCsrThreads / 32][32 * kStash];  // each warp's faces' planes
  __shared__ unsigned char queue[kCsrThreads / 32][32 * kCullBlocks];   // and its (lane, block) pairs
  const int tid = threadIdx.x;
  const CullGrid grid = cull_grid(tile_w);
  int next_units = seg_count[blockIdx.x];
  for (int round = 0, w; (w = snake_item(round)) < w_items; ++round) {
    const int n_units = next_units;
    if (snake_item(round + 1) < w_items) next_units = seg_count[snake_item(round + 1)];  // lands during this item
    float* o = out + (size_t)w * 5 * kCsrPixels + tid;
    if (n_units == 0) {
      if (tid < kCsrPixels) {
        o[0 * kCsrPixels] = kNeg;
        o[1 * kCsrPixels] = kBig;
        o[2 * kCsrPixels] = o[3 * kCsrPixels] = o[4 * kCsrPixels] = 0.0f;
      }
      continue;
    }
    const int x0 = tile_xy[2 * w], y0 = tile_xy[2 * w + 1];
    const int start = seg_start[w];
    const int ubase = unit_base[w];
    if (tid < kCsrPixels) zbuf[tid] = 0;
    __syncthreads();
    const int n_faces = n_units * pack;
    for (int base = 0; base < n_faces; base += kCsrThreads) {
      const int lf = base + tid;  // this thread's face slot within the segment
      unsigned gf = 0, live = 0;
      float rc[kPlanes];
      if (lf < n_faces) {
        gf = (unsigned)((ubase + sorted_unit[start + lf / pack]) * pack + lf % pack);
        load_planes<kRaw>(table, gf, rc);
        live = live_blocks(rc, x0, y0, grid);
      }
      scatter_warp(rc, gf, live, x0, y0, tile_w, grid, stash[tid >> 5], queue[tid >> 5], zbuf);
    }
    __syncthreads();
    if (tid < kCsrPixels) {
      // The pixel's winner, shaded from its planes (read again: one face a pixel).
      const unsigned long long key = zbuf[tid];
      Frag best = {kNeg, kBig, 0.0f, 0.0f, 0.0f};
      if (key != 0) {
        float rc[kPlanes];
        load_planes<kRaw>(table, ~(unsigned)key, rc);
        const float dx = __fsub_rn((float)(x0 + tid % tile_w), rc[0]);
        const float dy = __fsub_rn((float)(y0 + tid / tile_w), rc[1]);
        best = {zkey_q(key), rc[14], plane3(rc[16], rc[17], rc[18], dx, dy),
                plane3(rc[19], rc[20], rc[21], dx, dy), plane3(rc[22], rc[23], rc[24], dx, dy)};
      }
      o[0 * kCsrPixels] = best.q;
      o[1 * kCsrPixels] = best.fid;
      o[2 * kCsrPixels] = best.r;
      o[3 * kCsrPixels] = best.g;
      o[4 * kCsrPixels] = best.b;
    }
  }
}

#define CSR_KERNEL_ARGS                                                                          \
  const float* __restrict__ table,         /* (N, 32) face records, or the raw corner pack */  \
      const int* __restrict__ sorted_unit, /* flat CSR unit ids, ascending within a segment */ \
      const int* __restrict__ seg_start,   /* (W,) first unit slot of the tile */              \
      const int* __restrict__ seg_count,   /* (W,) units in the tile */                        \
      const int* __restrict__ tile_xy,     /* (W, 2) pixel origin (x0, y0) */                  \
      const int* __restrict__ unit_base,   /* (W,) sample * units per sample */                \
      float* __restrict__ out,             /* (W, 5, 128) [q, fid, rq, gq, bq] */              \
      int w_items, int pack, int tile_w

__global__ void __launch_bounds__(kCsrThreads, 1024 / kCsrThreads) csr_raster_kernel(CSR_KERNEL_ARGS) {
  csr_kernel_body<false>(table, sorted_unit, seg_start, seg_count, tile_xy, unit_base, out, w_items,
                         pack, tile_w);
}

__global__ void __launch_bounds__(kCsrThreads, 1024 / kCsrThreads) csr_planes_raster_kernel(CSR_KERNEL_ARGS) {
  csr_kernel_body<true>(table, sorted_unit, seg_start, seg_count, tile_xy, unit_base, out, w_items,
                        pack, tile_w);
}

// ---- The dense kernel: faces on threads for the cull, pixels on threads for the z-test ----

// The coordinate, within [lo, lo + extent), at which a plane with this
// coefficient along that axis is largest.
__device__ __forceinline__ float far_side(int lo, int extent, float coef) {
  return (float)(coef >= 0.0f ? lo + extent - 1 : lo);
}

__global__ void __launch_bounds__(kTileThreads, 1024 / kTileThreads) tile_raster_kernel(
    const float* __restrict__ records,      // (N, 32)
    const int* __restrict__ tf_global,      // (W, K) global face ids in draw order, -1 padded
    const int* __restrict__ counts,         // (W,)
    const int* __restrict__ tile_xy,        // (W, 2) pixel origin (x0, y0)
    float* __restrict__ out,                // (W, 4, P) [zq, rq, gq, bq]
    int w_items, int k_cap, int pixels, int tile_w, BlockShape shape) {
  constexpr int kWords = kTilePass / 32;
  constexpr int kOwn = kTileMaxPixels / kTileThreads;  // pixels a thread owns, all in one cull block
  static_assert(kOwn * kTileThreads == kTileMaxPixels && 16 % kOwn == 0, "a cull block shared by whole threads");
  __shared__ __align__(16) float stash[kTilePass * kStash];       // a pass's faces' planes and rows
  // Per cull block, the pass's faces that may cover it: one bit a face, in
  // list order.  Two copies: a pass fills one while the other is cleared.
  __shared__ unsigned block_faces[2][kTileMaxBlocks][kWords];
  const int tid = threadIdx.x;
  const int bw = shape.bw, bh = shape.bh, log_bw = __ffs(bw) - 1;
  const int n_blocks = pixels / 16, per_row = tile_w / bw;
  // 16 / kOwn neighbouring threads own the pixels of one cull block, kOwn each.
  const int own_k = tid / (16 / kOwn);
  const bool owner = own_k < n_blocks;
  int own_x[kOwn], own_y[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int i = kOwn * (tid % (16 / kOwn)) + j;
    own_x[j] = (own_k % per_row) * bw + (i & (bw - 1));
    own_y[j] = (own_k / per_row) * bh + (i >> log_bw);
  }
  for (int i = tid; i < 2 * kTileMaxBlocks * kWords; i += kTileThreads) (&block_faces[0][0][0])[i] = 0;
  __syncthreads();
  int fill = 0;  // the copy of block_faces that the next pass fills

  int next_cnt = counts[blockIdx.x];
  for (int round = 0, w; (w = snake_item(round)) < w_items; ++round) {
    const int cnt = min(next_cnt, k_cap);
    if (snake_item(round + 1) < w_items) next_cnt = counts[snake_item(round + 1)];  // lands during this item
    float* o = out + (size_t)w * 4 * pixels;
    if (cnt <= 0) {
      float4* o4 = reinterpret_cast<float4*>(o);  // row 0 is pixels / 4 float4s of -1e30, the rest zeros
      for (int i = tid; i < pixels; i += kTileThreads) {
        const float v = i < pixels / 4 ? kNeg : 0.0f;
        o4[i] = make_float4(v, v, v, v);
      }
      continue;
    }
    const int x0 = tile_xy[2 * w], y0 = tile_xy[2 * w + 1];
    const int* ids = tf_global + (size_t)w * k_cap;
    float best_q[kOwn];
    unsigned best_row[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) best_q[j] = kNeg, best_row[j] = 0;

    for (int base = 0; base < cnt; base += kTilePass, fill ^= 1) {
      unsigned(*lists)[kWords] = block_faces[fill];
      // The cull.  The pass's n faces take `slots` threads (a power of two)
      // in each of `parts` parts of the block; thread (f, part) tests face f
      // against blocks [part * per_part, (part + 1) * per_part) in row-major
      // order, at most 32.  An edge plane at the pixel of a block where it is largest is
      // ((a * dx) + (b * dy)) + c with dx from the block's column and dy from
      // its row alone, so a step along a row costs one product an edge.
      const int n = min(kTilePass, cnt - base);
      const int log_slots = max(32 - __clz(n - 1), 32 - __clz(kTileThreads / n_blocks - 1));
      const int f = tid & ((1 << log_slots) - 1), part = tid >> log_slots;
      const int parts = kTileThreads >> log_slots;
      const int per_part = (n_blocks + parts - 1) / parts;
      const int k_lo = part * per_part, k_hi = min(k_lo + per_part, n_blocks);
      for (int i = tid; i < kTileMaxBlocks * kWords; i += kTileThreads) (&block_faces[fill ^ 1][0][0])[i] = 0;
      if (f < n && k_lo < k_hi) {
        const unsigned row = (unsigned)max(ids[base + f], 0);
        float rc[kPlanes];
        load_planes<false>(records, row, rc);
        if (part == 0) stash_face(stash + f * kStash, rc, row);
        const float ea[3] = {rc[2], rc[5], rc[7]}, eb[3] = {rc[3], rc[6], rc[8]};
        unsigned live = 0;  // bit k - k_lo: block k may hold a covered pixel
        const int row_lo = k_lo / per_row, row_hi = (k_hi - 1) / per_row;
        for (int brow = row_lo, k = k_lo; brow <= row_hi; ++brow) {
          const int col_lo = k - brow * per_row, col_hi = min(per_row, k_hi - brow * per_row);
          float xs[3], tb[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            xs[e] = far_side(x0 + col_lo * bw, bw, ea[e]);
            tb[e] = __fmul_rn(eb[e], __fsub_rn(far_side(y0 + brow * bh, bh, eb[e]), rc[1]));
          }
#pragma unroll 4
          for (int col = col_lo; col < col_hi; ++col, ++k) {
            float edge[3];
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              edge[e] = __fadd_rn(__fmul_rn(ea[e], __fsub_rn(xs[e], rc[0])), tb[e]);
              xs[e] = __fadd_rn(xs[e], (float)bw);  // whole numbers: exact
            }
            edge[0] = __fadd_rn(edge[0], rc[4]);
            const bool outside = edge[0] < 0.0f || edge[1] < 0.0f || edge[2] < 0.0f;
            live |= (kAblate == 1 || !outside ? 1u : 0u) << (k - k_lo);
          }
        }
        for (; live; live &= live - 1) atomicOr(&lists[k_lo + __ffs(live) - 1][f >> 5], 1u << (f & 31));
      }
      __syncthreads();
      // The z-test.  A thread walks the live faces of its block in list order
      // and tests its pixels with the strict test: the first of equal faces
      // stays.
      if (owner) {
        const int n_words = (n + 31) >> 5;
        for (int word = 0; word < n_words; ++word) {
          for (unsigned m = lists[own_k][word]; m; m &= m - 1) {
            const float4* face = reinterpret_cast<const float4*>(stash + (32 * word + __ffs(m) - 1) * kStash);
            const float4 a = face[0], b = face[1], c = face[2], d = face[3];
#pragma unroll
            for (int j = 0; j < kOwn; ++j) {
              const float dx = __fsub_rn((float)(x0 + own_x[j]), a.x);
              const float dy = __fsub_rn((float)(y0 + own_y[j]), a.y);
              const float e0 = plane3(a.z, a.w, b.x, dx, dy);
              const float e1 = plane2(b.y, b.z, dx, dy);
              const float e2 = plane2(b.w, c.x, dx, dy);
              const float qi = fminf(fmaxf(plane3(c.y, c.z, c.w, dx, dy), d.x), d.y);
              if (fminf(e0, fminf(e1, e2)) >= 0.0f && qi > best_q[j]) {
                best_q[j] = qi;
                best_row[j] = __float_as_uint(d.z);
              }
            }
          }
        }
      }
      __syncthreads();  // the stash is free again; this pass's lists may be cleared
    }
    if (owner) {
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        // The pixel's winner, shaded from its colour planes (read again: one face a pixel).
        float r = 0.0f, g = 0.0f, b = 0.0f;
        if (best_q[j] > kNeg) {
          const float4* row = reinterpret_cast<const float4*>(records + (size_t)best_row[j] * kRec);
          const float4 a = __ldg(row), c4 = __ldg(row + 4), c5 = __ldg(row + 5), c6 = __ldg(row + 6);
          const float dx = __fsub_rn((float)(x0 + own_x[j]), a.x);
          const float dy = __fsub_rn((float)(y0 + own_y[j]), a.y);
          r = plane3(c4.x, c4.y, c4.z, dx, dy);
          g = plane3(c4.w, c5.x, c5.y, dx, dy);
          b = plane3(c5.z, c5.w, c6.x, dx, dy);
        }
        const int p = own_y[j] * tile_w + own_x[j];
        o[p] = best_q[j];
        o[pixels + p] = r;
        o[2 * pixels + p] = g;
        o[3 * pixels + p] = b;
      }
    }
  }
}

// ---- The CSR binning: count, offsets, scatter, order ----

constexpr int kBinThreads = 256;     // count and scatter: one (sample, unit) a thread
constexpr int kOffsetThreads = 1024; // offsets: one block a sample
constexpr int kOrderWarps = 4;       // order: one tile a warp at a time
constexpr int kOrderShared = 2048;   // units a warp orders in shared memory
constexpr int kMaxBinTiers = 64;     // runs of the budget (tune_raster_for_bank makes at most 16)

// The budget: units [end[i - 1], end[i]) keep at most cap[i] tiles each
// (end[-1] = 0; each cap already at most the tile count).  Passed by value,
// read with constant indices only, so it stays in the parameter bank.
struct BinBudget {
  int n;
  int end[kMaxBinTiers];
  int cap[kMaxBinTiers];
};

struct BinGeometry {
  int tile_h, tile_w, t_y, t_x, height, width;
};

__device__ __forceinline__ int unit_cap(const BinBudget& budget, int unit) {
  int cap = budget.cap[0];
#pragma unroll
  for (int i = 1; i < kMaxBinTiers; ++i) {
    if (i < budget.n && unit >= budget.end[i - 1]) cap = budget.cap[i];
  }
  return cap;
}

// The tile bound of a screen coordinate: rasterizer._bbox_tiles'
// clamp(floor(x / side), 0, tiles - 1) in float32, then an integer.
__device__ __forceinline__ int tile_bound(float x, int side, int tiles) {
  return (int)fminf(fmaxf(floorf(__fdiv_rn(x, (float)side)), 0.0f), (float)(tiles - 1));
}

// A unit's tile bbox: the union over its valid on-screen faces of their
// clamped tile bounds, as bin_faces_csr forms it.  False when no face of
// the unit is valid and on screen.
struct TileBox {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ bool unit_box(const float* __restrict__ fu, const float* __restrict__ fv,
                                         const bool* __restrict__ valid, size_t face0, int pack,
                                         const BinGeometry& g, TileBox& box) {
  bool any = false;
  box = {g.t_x - 1, 0, g.t_y - 1, 0};
  for (int j = 0; j < pack; ++j) {
    const size_t f = face0 + j;
    if (!valid[f]) continue;
    const float u0 = fu[3 * f], u1 = fu[3 * f + 1], u2 = fu[3 * f + 2];
    const float v0 = fv[3 * f], v1 = fv[3 * f + 1], v2 = fv[3 * f + 2];
    const float umin = fminf(u0, fminf(u1, u2)), umax = fmaxf(u0, fmaxf(u1, u2));
    const float vmin = fminf(v0, fminf(v1, v2)), vmax = fmaxf(v0, fmaxf(v1, v2));
    if (umax < 0.0f || umin > (float)(g.width - 1) || vmax < 0.0f || vmin > (float)(g.height - 1)) continue;
    any = true;
    box.x0 = min(box.x0, tile_bound(umin, g.tile_w, g.t_x));
    box.x1 = max(box.x1, tile_bound(umax, g.tile_w, g.t_x));
    box.y0 = min(box.y0, tile_bound(vmin, g.tile_h, g.t_y));
    box.y1 = max(box.y1, tile_bound(vmax, g.tile_h, g.t_y));
  }
  return any;
}

// fn(tile) for the first `kept` tiles of the box in row-major order.
template <typename Fn>
__device__ __forceinline__ void for_kept_tiles(const TileBox& box, int kept, int t_x, Fn fn) {
  for (int y = box.y0, slot = 0; slot < kept; ++y) {
    for (int x = box.x0; x <= box.x1 && slot < kept; ++x, ++slot) fn(y * t_x + x);
  }
}

__global__ void __launch_bounds__(kBinThreads) csr_bin_count_kernel(
    const float* __restrict__ fu, const float* __restrict__ fv,  // (B, F, 3) projected corners
    const bool* __restrict__ valid,                              // (B, F) render validity
    unsigned long long* __restrict__ counts,                     // (B, T) pairs a tile, zeroed
    unsigned long long* __restrict__ dropped,                    // (B,) pairs past the budget, zeroed
    int batch, int n_units, int pack, BinBudget budget, BinGeometry g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n_units) return;
  const int b = i / n_units, unit = i % n_units;
  TileBox box;
  if (!unit_box(fu, fv, valid, (size_t)i * pack, pack, g, box)) return;
  const int span = (box.x1 - box.x0 + 1) * (box.y1 - box.y0 + 1);
  const int kept = min(span, unit_cap(budget, unit));
  if (span > kept) atomicAdd(dropped + b, (unsigned long long)(span - kept));
  unsigned long long* row = counts + (size_t)b * g.t_y * g.t_x;
  for_kept_tiles(box, kept, g.t_x, [&](int tile) { atomicAdd(row + tile, 1ull); });
}

// One block a sample: offsets = the exclusive prefix sum of the sample's
// tile counts; cursor = the same, in 32 bits, for the scatter's atomics.
__global__ void __launch_bounds__(kOffsetThreads) csr_bin_offsets_kernel(
    const long long* __restrict__ counts, long long* __restrict__ offsets, int* __restrict__ cursor,
    int n_tiles) {
  __shared__ long long warp_total[kOffsetThreads / 32];
  const size_t row = (size_t)blockIdx.x * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + kOffsetThreads - 1) / kOffsetThreads;
  const int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
  long long own = 0;
  for (int t = lo; t < hi; ++t) own += counts[row + t];
  long long incl = own;  // inclusive sum over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long below = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += below;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_total[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long below = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += below;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  long long at = incl - own + (warp ? warp_total[warp - 1] : 0);
  for (int t = lo; t < hi; ++t) {
    offsets[row + t] = at;
    cursor[row + t] = (int)at;
    at += counts[row + t];
  }
}

__global__ void __launch_bounds__(kBinThreads) csr_bin_scatter_kernel(
    const float* __restrict__ fu, const float* __restrict__ fv, const bool* __restrict__ valid,
    int* __restrict__ cursor,       // (B, T) each tile's next free slot, from the offsets
    int* __restrict__ sorted_unit,  // (B, capacity) the segments
    int batch, int n_units, int pack, int capacity, BinBudget budget, BinGeometry g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n_units) return;
  const int b = i / n_units, unit = i % n_units;
  TileBox box;
  if (!unit_box(fu, fv, valid, (size_t)i * pack, pack, g, box)) return;
  const int span = (box.x1 - box.x0 + 1) * (box.y1 - box.y0 + 1);
  const int kept = min(span, unit_cap(budget, unit));
  int* row = cursor + (size_t)b * g.t_y * g.t_x;
  int* out = sorted_unit + (size_t)b * capacity;
  for_kept_tiles(box, kept, g.t_x, [&](int tile) { out[atomicAdd(row + tile, 1)] = unit; });
}

// Ascending order of a[0 .. n) by the warp: a bitonic network whose merges
// all ascend (each stage's first step compares mirrored positions), so the
// virtual entries past n, read as +inf, never move and every comparison
// that reaches one is skipped.  `a` may lie in shared or device memory
// (__syncwarp orders the warp's accesses to either).
__device__ void warp_bitonic(int* a, int n, int lane) {
  int width = 1;
  while (width < n) width <<= 1;
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int p = lane; p < width / 2; p += 32) {
        const int base = (p / j) * 2 * j, off = p % j;
        const int lo = base + off;
        const int hi = j == (k >> 1) ? base + 2 * j - 1 - off : lo + j;  // the mirror, then half-cleaners
        if (hi < n) {
          const int x = a[lo], y = a[hi];
          if (x > y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Resident blocks; warp w of the grid's W takes tiles w, w + W, ... with
// the next tile's count already loaded, so an empty tile costs one load.
__global__ void __launch_bounds__(32 * kOrderWarps) csr_bin_order_kernel(
    const long long* __restrict__ offsets, const long long* __restrict__ counts,
    int* __restrict__ sorted_unit, int n_segments, int n_tiles, int capacity) {
  __shared__ int stage[kOrderWarps][kOrderShared];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kOrderWarps;
  int s = blockIdx.x * kOrderWarps + warp;
  long long next = s < n_segments ? counts[s] : 0;
  for (; s < n_segments; s += stride) {
    const int n = (int)next;
    if (s + stride < n_segments) next = counts[s + stride];
    if (n < 2) continue;
    int* seg = sorted_unit + (size_t)(s / n_tiles) * capacity + offsets[s];
    if (n <= kOrderShared) {
      int* own = stage[warp];
      for (int p = lane; p < n; p += 32) own[p] = seg[p];
      __syncwarp();
      warp_bitonic(own, n, lane);
      for (int p = lane; p < n; p += 32) seg[p] = own[p];
    } else {
      warp_bitonic(seg, n, lane);
    }
    __syncwarp();  // the stage is free again
  }
}

// Blocks of `threads` threads that the card holds at once: a kernel's grid.
int resident_blocks(const void* kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return max(1, sms * per_sm);
}

}  // namespace

extern "C" int csr_raster_launch(const void* records, const void* sorted_unit,
                                 const void* seg_start, const void* seg_count,
                                 const void* tile_xy, const void* unit_base, void* out,
                                 int w_items, int pack, int tile_w, void* stream) {
  if (w_items > 0) {
    static const int resident = resident_blocks((const void*)csr_raster_kernel, kCsrThreads);
    csr_raster_kernel<<<min(w_items, resident), kCsrThreads, 0, (cudaStream_t)stream>>>(
        (const float*)records, (const int*)sorted_unit, (const int*)seg_start,
        (const int*)seg_count, (const int*)tile_xy, (const int*)unit_base, (float*)out,
        w_items, pack, tile_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int csr_planes_raster_launch(const void* raw, const void* sorted_unit,
                                        const void* seg_start, const void* seg_count,
                                        const void* tile_xy, const void* unit_base, void* out,
                                        int w_items, int pack, int tile_w, void* stream) {
  if (w_items > 0) {
    static const int resident = resident_blocks((const void*)csr_planes_raster_kernel, kCsrThreads);
    csr_planes_raster_kernel<<<min(w_items, resident), kCsrThreads, 0, (cudaStream_t)stream>>>(
        (const float*)raw, (const int*)sorted_unit, (const int*)seg_start,
        (const int*)seg_count, (const int*)tile_xy, (const int*)unit_base, (float*)out,
        w_items, pack, tile_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int tile_raster_launch(const void* records, const void* tf_global,
                                  const void* counts, const void* tile_xy, void* out,
                                  int w_items, int k_cap, int tile_pixels, int tile_w,
                                  void* stream) {
  if (tile_w <= 0 || tile_pixels <= 0 || tile_pixels > kTileMaxPixels || tile_pixels % 32 ||
      tile_pixels % tile_w) {
    return (int)cudaErrorInvalidValue;
  }
  if (w_items > 0) {
    static const int resident = resident_blocks((const void*)tile_raster_kernel, kTileThreads);
    tile_raster_kernel<<<min(w_items, resident), kTileThreads, 0, (cudaStream_t)stream>>>(
        (const float*)records, (const int*)tf_global, (const int*)counts,
        (const int*)tile_xy, (float*)out, w_items, k_cap, tile_pixels, tile_w,
        cull_block_shape(tile_w, tile_pixels / tile_w));
  }
  return (int)cudaGetLastError();
}

// The four binning kernels in turn on one stream.  tallies: (B * T + B)
// int64, the counts then the dropped counts, zeroed here; offsets (B, T)
// int64; cursor (B, T) int32 scratch; sorted_unit (B, capacity) int32.
// *launched: the kernels launched (4; fewer for an empty batch or bank).
extern "C" int csr_bin_launch(const void* fu, const void* fv, const void* valid, void* sorted_unit,
                              void* offsets, void* tallies, void* cursor, int batch, int n_units,
                              int pack, int capacity, const int* tier_end, const int* tier_cap,
                              int n_tiers, int tile_h, int tile_w, int height, int width, void* stream,
                              int* launched) {
  *launched = 0;
  if (n_tiers < 1 || n_tiers > kMaxBinTiers || pack < 1 || tile_h < 1 || tile_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  BinBudget budget = {};
  budget.n = n_tiers;
  for (int i = 0; i < n_tiers; ++i) {
    budget.end[i] = tier_end[i];
    budget.cap[i] = tier_cap[i];
  }
  const BinGeometry g = {tile_h, tile_w, (height + tile_h - 1) / tile_h, (width + tile_w - 1) / tile_w,
                         height, width};
  const int n_tiles = g.t_y * g.t_x;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* counts = (unsigned long long*)tallies;
  cudaError_t rc = cudaMemsetAsync(tallies, 0, ((size_t)batch * n_tiles + batch) * sizeof(long long), s);
  if (rc != cudaSuccess || batch == 0) return (int)rc;
  const int items = batch * n_units;
  const int bin_blocks = (items + kBinThreads - 1) / kBinThreads;
  if (items > 0) {
    csr_bin_count_kernel<<<bin_blocks, kBinThreads, 0, s>>>(
        (const float*)fu, (const float*)fv, (const bool*)valid, counts, counts + (size_t)batch * n_tiles,
        batch, n_units, pack, budget, g);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    ++*launched;
  }
  csr_bin_offsets_kernel<<<batch, kOffsetThreads, 0, s>>>((const long long*)tallies, (long long*)offsets,
                                                          (int*)cursor, n_tiles);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  ++*launched;
  if (items > 0) {
    csr_bin_scatter_kernel<<<bin_blocks, kBinThreads, 0, s>>>(
        (const float*)fu, (const float*)fv, (const bool*)valid, (int*)cursor, (int*)sorted_unit, batch,
        n_units, pack, capacity, budget, g);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    ++*launched;
  }
  const int segments = batch * n_tiles;
  static const int resident = resident_blocks((const void*)csr_bin_order_kernel, 32 * kOrderWarps);
  csr_bin_order_kernel<<<min((segments + kOrderWarps - 1) / kOrderWarps, resident), 32 * kOrderWarps, 0, s>>>(
      (const long long*)offsets, (const long long*)tallies, (int*)sorted_unit, segments, n_tiles, capacity);
  if ((rc = cudaGetLastError()) == cudaSuccess) ++*launched;
  return (int)rc;
}
