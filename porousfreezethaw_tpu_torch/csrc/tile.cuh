// The tile engine of the stencil kernels (delta_g.cu, and stage.cuh for
// fused_stage.cu and fused_attempt.cu): how a block's input planes reach
// shared memory, and how a launch's grid is sized.
//
// * One block per (x, y) tile of TILE_X x TILE_Y own points, one thread per
//   point, marching a chunk of tz planes; the chunk is chosen at launch so
//   that the blocks fill the card in whole waves (tile_grid).
// * Each plane's rows of raw inputs (w's u, p, gl, then the (u, p) of each
//   K or G input) over the tile and its one-point x/y halo are copied to
//   shared memory with cp.async in whole chunks of 16 bytes (4 floats or 2
//   doubles; 8 or 4 bytes where the rows are not 16-byte aligned, as at
//   X = 50 in float32), the 16-byte copies through L2 only: each element
//   is read from device memory once per plane, apart from the halo.  The
//   input rows follow the y mirror, decided on the global row; a tile cell
//   past the x edge reads the edge's column, so the compute needs no
//   boundary case.
// * A ring of raw planes in flight while the block assembles one and
//   computes the one before it, one barrier per plane (its depth and when a
//   buffer is refilled are the kernel's).  The planes below and above a
//   chunk are copied for the tile's own rows only.
//
// The kernels differ in what they assemble from the raw values of a point
// (5 values for the delta kernel, 3 for the stage) and in their
// instantiations, whose occupancy sizes the grid; both are parameters here.
// The argument blocks of both kernels have the members the engine reads:
// plane[RAW], g and vec.  The element type T of the planes is float, or
// double for the stage kernel's float64 entry: a raw row, a copy and the
// shared memory of a launch are sized from sizeof(T).
#pragma once

#include "freezing.cuh"

namespace pft {

constexpr int RAW = 9;     // raw planes: w's (u, p, gl), then each K's (u, p)

// The tile of own points of one block (x by y).  50 x 10 fills every lane
// at the grids' widths of 50, 100 and 200, and was the fastest of the tiles
// compared at MR, LR and on a z4 shard of MR (PERF.md).
constexpr int TILE_X = 50, TILE_Y = 10;
constexpr int TILE_POINTS = TILE_X * TILE_Y;
constexpr int TILE_THREADS = (TILE_POINTS + 31) / 32 * 32;
// the blocks an SM should hold: ptxas keeps a thread's registers to 64
constexpr int BLOCKS_PER_SM = TILE_THREADS < 1024 ? 1024 / TILE_THREADS : 1;
// ... in the field's width: a float64 point holds its values in register
// pairs, so one block of 512 threads an SM leaves each thread 128
// registers
template <class T>
constexpr int BLOCKS_PER_SM_T = sizeof(T) == 4 ? BLOCKS_PER_SM : 1;
constexpr int HALO_X = TILE_X + 2;                  // the tile with its halo
constexpr int ROWS = TILE_Y + 2;
constexpr int HALO_CELLS = HALO_X * ROWS;
constexpr int HALO_RING = HALO_CELLS - TILE_POINTS; // cells around the tile
// the elements of T in one 16-byte copy: 4 floats, 2 doubles
template <class T>
constexpr int VEC_MAX = 16 / (int)sizeof(T);
// a raw row: the tile's HALO_X columns from a start aligned down to
// VEC_MAX elements, so that whole 16-byte chunks of a row are copied
template <class T>
constexpr int PITCH_T = (HALO_X + 2 * (VEC_MAX<T> - 1)) / VEC_MAX<T>
                        * VEC_MAX<T>;
template <class T>
constexpr int RAW_PLANE_T = ROWS * PITCH_T<T>;
constexpr int PITCH = PITCH_T<float>;
constexpr int RAW_PLANE = RAW_PLANE_T<float>;
static_assert(HALO_RING <= TILE_THREADS, "bad tile");

// dynamic shared memory of a launch with nk inputs of T that keeps a ring
// of RING_ raw planes (each of 3 + 2 nk rows blocks) and assembles NPT
// values per point: the ring, then two assembled planes of NPT values per
// tile cell
template <int NPT, int RING_, class T = float>
constexpr int tile_smem_bytes(int nk) {
    return (int)sizeof(T) * (RING_ * (3 + 2 * nk) * RAW_PLANE_T<T>
                             + 2 * NPT * HALO_CELLS);
}

// cp.async of VEC elements from device to shared memory (16 bytes through
// L2 only), its commit and wait
template <int VEC, class T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
    constexpr int BYTES = VEC * (int)sizeof(T);
    static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "bad copy");
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(d), "l"(src) : "memory");
    else if constexpr (BYTES == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's newest groups of copies are
// pending
template <int N>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where a block's planes come from and go to.  A raw plane in shared
// memory holds the ROWS rows of the tile with its halo; a row holds the
// elements [xa, xa + PITCH_T) of an input row, xa = x0 - 1 aligned down to a
// multiple of the copy width.  The input rows follow the y mirror, decided
// on the global row; the x mirror is left to the readers: a tile cell past
// the grid's edge reads the edge's column.  Thread t < TILE_POINTS owns
// the tile cell of point t; thread t < HALO_RING also assembles halo cell t
// of the ring around the tile (the row below, the row above, the left
// column, the right column).
struct TileMap {
    int xa;                // the global x of raw column 0
    int ctr, halo;         // tile cells of this thread (halo < 0: none)
    int ctr_raw, halo_raw; // their places in a raw plane
};

template <class T>
__device__ __forceinline__ int raw_cell(int X, int x0, int xa, int cell) {
    const int r = cell / HALO_X;
    const int xs = min(max(x0 - 1 + cell - r * HALO_X, 0), X - 1);
    return r * PITCH_T<T> + xs - xa;
}

template <class T = float>
__device__ __forceinline__ TileMap tile_map(int X, int x0, int vec) {
    const int t = threadIdx.x;
    TileMap m{((x0 - 1 + vec) / vec - 1) * vec, 0, -1, 0, 0};
    if (t < TILE_POINTS)
        m.ctr = (t / TILE_X + 1) * HALO_X + t % TILE_X + 1;
    if (t < HALO_RING) {
        constexpr int LEFT = 2 * HALO_X, RIGHT = LEFT + TILE_Y;
        m.halo = t < HALO_X ? t
            : t < LEFT ? (TILE_Y + 1) * HALO_X + t - HALO_X
            : t < RIGHT ? (t - LEFT + 1) * HALO_X
            : (t - RIGHT + 1) * HALO_X + HALO_X - 1;
        m.halo_raw = raw_cell<T>(X, x0, m.xa, m.halo);
    }
    m.ctr_raw = raw_cell<T>(X, x0, m.xa, m.ctr);
    return m;
}

// The offset within an input plane of the row of tile row r: own row yo0 -
// 1 + r, clamped to the shard's rows and its neighbour rows, the mirror
// decided on the global row.
__device__ __forceinline__ int row_offset(const ShardArgs& s, int X, int yo0,
                                          int r) {
    const int yc = min(max(yo0 - 1 + r, -1), s.Yl);     // own row
    const int gy = min(max(s.y0 + yc, 0), s.Yg - 1);    // global row
    return (s.r0 + gy - s.y0) * X;
}

// Starts the copies of rows [r0, r0 + rows) of one plane into raw, VEC
// elements at a time: the raw planes q of the plane are at base + q *
// qstride (a ghost stack), or at a.plane[q] + zoff.  Whole chunks of a row
// lie inside [0, X) or outside it, as VEC divides X; those outside, or
// past the tile's last column, are not copied.
template <int NK, int VEC, class Args, class T>
__device__ __forceinline__ void copy_rows(const Args& a, const T* base,
                                          int64_t qstride, int64_t zoff,
                                          const int* rowoff, int xa, int xlim,
                                          int r0, int rows, T* raw) {
    constexpr int NR = 3 + 2 * NK, CHUNKS = PITCH_T<T> / VEC;
    static_assert(PITCH_T<T> % VEC == 0, "bad copy width");
#pragma unroll 1
    for (int i = threadIdx.x; i < rows * CHUNKS; i += TILE_THREADS) {
        const int r = r0 + i / CHUNKS, j = i % CHUNKS;
        const int x = xa + j * VEC;
        if (x < 0 || x >= xlim) continue;
        const int64_t off = zoff + rowoff[r] + x;
        T* dst = raw + r * PITCH_T<T> + j * VEC;
#pragma unroll
        for (int q = 0; q < NR; ++q)
            copy_async<VEC>(dst + q * RAW_PLANE_T<T>,
                            (base ? base + q * qstride : a.plane[q]) + off);
    }
}

// Starts the copies of plane pz (z0 - 1 <= pz <= z1) into raw and commits
// them as one group: all ROWS rows of an own plane, the tile's own rows of
// the planes below and above the chunk.  Below plane 0 and above plane Z-1
// the plane is the shard's ghost stack (3 + 2 NK, Y, X), or the mirror.
template <int NK, class Args, class T>
__device__ __forceinline__ void stage_plane(const Args& a, const ShardArgs& s,
                                            const int* rowoff, int xa,
                                            int xlim, int pz, bool whole,
                                            T* raw) {
    const int64_t P = a.g.plane();
    // the float64 entry is single-device: no ghost stacks
    const T* ghost = nullptr;
    if constexpr (sizeof(T) == 4)
        ghost = pz < 0 ? s.glo : pz >= a.g.Z ? s.ghi : nullptr;
    const int64_t zoff = ghost ? 0 : min(max(pz, 0), a.g.Z - 1) * P;
    const int r0 = whole ? 0 : 1, rows = whole ? ROWS : TILE_Y;
    constexpr int W = VEC_MAX<T>;
    if (a.vec == W) {
        copy_rows<NK, W>(a, ghost, P, zoff, rowoff, xa, xlim, r0, rows, raw);
    } else if constexpr (W == 4) {
        if (a.vec == 2)
            copy_rows<NK, 2>(a, ghost, P, zoff, rowoff, xa, xlim, r0, rows,
                             raw);
        else
            copy_rows<NK, 1>(a, ghost, P, zoff, rowoff, xa, xlim, r0, rows,
                             raw);
    } else {
        copy_rows<NK, 1>(a, ghost, P, zoff, rowoff, xa, xlim, r0, rows, raw);
    }
    copy_commit();
}

// The raw values of place i of the raw buffer raw into r
template <int NK, class T>
__device__ __forceinline__ void raw_values(const T* raw, int i, T* r) {
#pragma unroll
    for (int q = 0; q < 3 + 2 * NK; ++q) r[q] = raw[q * RAW_PLANE_T<T> + i];
}

// The widest copy (4, 2 or 1 floats; 2 or 1 doubles) that every row of the
// raw planes plane[0 .. nr) and the rows of X elements allow.
template <class T>
inline int copy_width(const T* const* plane, int nr, int X) {
    uintptr_t addr = 0;
    for (int q = 0; q < nr; ++q)
        addr |= reinterpret_cast<uintptr_t>(plane[q]);
    for (int v = VEC_MAX<T>; v > 1; v /= 2)
        if (X % v == 0 && addr % (v * sizeof(T)) == 0) return v;
    return 1;
}

// ... narrowed to what the ghost stacks' addresses allow
inline int ghost_width(int vec, const float* glo, const float* ghi) {
    const uintptr_t ghosts = reinterpret_cast<uintptr_t>(glo)
                             | reinterpret_cast<uintptr_t>(ghi);
    while (vec > 1 && ghosts % (4 * vec)) vec /= 2;
    return vec;
}

// The launch grid: the tiles of own points in x and y, and the chunks of
// tz planes in z.  All blocks of a launch should run in one wave, or in
// whole waves: a block's time is about its planes plus one (the pipeline's
// start and the planes around the chunk), so the chunk count minimises
// waves x (tz + 1) over the card's resident blocks of the kernel.
struct TileGrid {
    dim3 grid;
    int tz;
};

constexpr int MAX_DEVICES = 64;

// The blocks of kernel that the current device holds at once with bytes of
// dynamic shared memory, into cap; resident[] caches them per device (one
// array per kernel).  On first use on a device it also lets the kernel use
// the most shared memory an SM has, so that as many blocks are resident as
// the occupancy query counts; above 48 KB a block gets it only after
// opting in.
template <class Kernel>
int resident_blocks(Kernel* kernel, int bytes, int* resident, int& cap) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess && dev < MAX_DEVICES && resident[dev]) {
        cap = resident[dev];
        return 0;
    }
    if (rc == cudaSuccess)
        rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (rc == cudaSuccess && bytes > 48 * 1024)
        rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, TILE_THREADS, bytes);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (rc != cudaSuccess) return (int)rc;
    cap = max(per_sm * sms, 1);
    if (dev < MAX_DEVICES) resident[dev] = cap;
    return 0;
}

// The grid over Z planes of Yl own rows of X points for cap resident
// blocks.
inline TileGrid tile_grid(int cap, int Z, int Yl, int X) {
    const long long tiles = (long long)((X + TILE_X - 1) / TILE_X)
                            * ((Yl + TILE_Y - 1) / TILE_Y);
    // for each wave count, the most chunks that fit it
    int best = 1;
    long long best_cost = -1;
    for (long long w = (tiles + cap - 1) / cap; w * cap < tiles * Z + cap;
         ++w) {
        const int nz = (int)min((long long)Z, w * cap / tiles);
        const long long cost = (tiles * nz + cap - 1) / cap
                               * ((Z + nz - 1) / nz + 1);
        if (best_cost < 0 || cost < best_cost) {
            best = nz;
            best_cost = cost;
        }
    }
    TileGrid out;
    out.tz = (Z + best - 1) / best;
    out.grid = dim3((X + TILE_X - 1) / TILE_X, (Yl + TILE_Y - 1) / TILE_Y,
                    (Z + out.tz - 1) / out.tz);
    return out;
}

}  // namespace pft
