// The backward of the embedding gathers (models/gather.py:gather_rows) on the
// card: d(table)[v, :] = the sum of cot[n, :] over the tokens n whose code is
// v, in an order that depends on the shapes alone.
//
// It replaces no Pallas kernel: the JAX package leaves its gather's VJP to
// XLA's scatter-add. On the card the gathers' backward was `index_put_` with
// accumulation (the index form `table[codes]`), which radix-sorts the codes
// and then gives one thread to each (distinct row, column), walking every
// duplicate of its row in series. About 45% of the corpus's 102,400 codes a
// batch are the padding row, so one serial walk of some 46,000 adds set that
// kernel's time (10.0 ms at E 32 f32, 34.7 ms at E 64 bf16, H100), and it
// rounded its running sum to the table's dtype after every add in bf16.
// F.embedding's CUDA backward is fast but sums with float atomics, in an
// order that changes from run to run, which a resumed run cannot replay.
//
// What bounds it on an H100: bytes. The flagship's cotangent is
// 1024 x 100 x 32 f32 (13.1 MB; hc307m's E 64 bf16 the same), the codes
// 0.8 MB, the output 16-32 KB: about 4.2 us at 3.35 TB/s. There are no
// products to speak of.
//
// f32 tables, two kernels:
//   * gather_rows_bwd_partial, grid (chunks, tiles of the table): a block
//     takes a fixed chunk of consecutive tokens and splits it into one
//     contiguous range a warp. A warp streams its range through a stage in
//     shared memory in 16-byte loads (the next stage's loads in flight while
//     it adds the current one) and adds each token's row into a private f32
//     table in shared memory. A lane owns its columns (lane, lane + L, ...),
//     so no two threads ever touch one address and nothing is atomic; for
//     E < 32 the warp's lanes split into 32 / L groups of L lanes, group g
//     taking the range's tokens g, g + G, ..., each group with its own table.
//     A run of one code (the padding tail of a string) is summed in
//     registers: the row is read from the table when the run starts and
//     written back when it ends, the same order of adds as one at a time.
//     The block then sums its walkers' tables in walker order into one f32
//     partial a chunk in a workspace the wrapper allocates. Where the
//     walkers' tables do not fit, the table's rows are tiled over grid.y and
//     each block adds only the tokens of its tile.
//   * gather_rows_bwd_sum sums the chunks' partials in chunk order (S fixed
//     sub-ranges of chunks, each summed by one thread, then the S sums in
//     order).
// So the order of every sum is a function of (N, V, E), no thread's serial
// work grows with the duplicates of a row (it is bounded by a warp's
// range), and the cotangent is read once. `afr_gather_rows_plan` gives the
// plan; ops/gather_rows.py:gather_rows_plan mirrors it and the plain version
// sums in the same order, so the card holds the kernels to it bit for bit.
//
// bf16 tables, gather_rows_bwd_ordered: the order of the index form's
// backward, which the benchmark's reference for a bf16 frontend computes
// too (its gather is the index form): for each (row, column), the row's
// tokens in token order added in f32, the running sum rounded back to bf16
// after every add where the row is wider than 32 (as PyTorch's general
// indexing_backward_kernel), once at the end where it is not (as its
// small-stride kernel). The card tests hold it to index_put_'s bits at
// widths 32 and 64; at width 1 PyTorch sums in another order. At hc307m's
// E 64 an f32 sum with one
// rounding lies far nearer the exact sum (0.93 against 135 on the padding
// row, H100), but a gradient that far from the reference's fails its
// check. The sum is serial by definition, so the kernel keeps the serial
// walk free of global loads: a block a (row, 64 columns), whose warps 1-7
// list the row's tokens among the next 512 by ballot and copy their
// cotangents into shared memory while warp 0 adds the previous 512's in
// order, one bf16 add each, where the index form waits on two dependent
// loads for every duplicate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSms = 132;
constexpr long long kSmemPerSm = 233472;     // 228 KB an SM
constexpr long long kSmemPerBlock = 232448;  // 227 KB a block
constexpr long long kReservedPerBlock = 1024;
constexpr int kStageBytes = 2048;   // cotangent bytes a warp stage holds, at most
constexpr int kTableBytes = 32768;  // a warp's tables, at most
constexpr int kMaxWarps = 8;
// Warps an SM holds by registers: the partial pass is built for 3 blocks of
// 256 threads (__launch_bounds__), at most 85 registers a thread.
constexpr int kRegWarps = 24;
constexpr int kMaxStageRows = 256;
constexpr int kMaxWidth = 256;
constexpr int kMaxCols = 8;  // columns a lane: kMaxWidth / 32
constexpr int kSumThreads = 256;
constexpr int kMaxSplits = 32;
constexpr int kOrderedChunk = 512;  // tokens a fill of the ordered kernel
constexpr int kOrderedCols = 64;    // columns an ordered block: two a lane of its adding warp
constexpr int kOrderedWarps = 8;    // warp 0 adds, the others fill

struct Plan {
  long long lanes, groups, cols, rows, vt, tiles, warps, blocks_per_sm, warp_tokens, chunk, chunks, splits,
      per_split, smem_bytes;
};
constexpr int kPlanFields = 14;

long long gcd(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

long long round16(long long x) { return (x + 15) / 16 * 16; }

long long block_smem(const Plan& p, long long warps, long long width) {
  return round16(4 * warps * p.groups * p.vt * width) + warps * (p.rows * width * 4 + 4 * p.rows);
}

// The plan for n tokens of a [num_rows, width] f32 table; false where the
// kernels do not take the shape.
bool make_plan(long long n, long long num_rows, long long width, Plan* p) {
  if (n < 0 || num_rows <= 0 || width <= 0 || width > kMaxWidth) return false;
  p->lanes = 1;
  while (p->lanes * 2 <= (width < 32 ? width : 32)) p->lanes *= 2;
  p->groups = 32 / p->lanes;
  p->cols = cdiv(width, p->lanes);
  const long long row_bytes = width * 4;
  const long long g16 = 16 / gcd(16, row_bytes);
  const long long unit = p->groups / gcd(p->groups, g16) * g16;  // lcm(groups, g16)
  long long per = kStageBytes / (row_bytes * unit);
  p->rows = unit * (per > 1 ? per : 1);
  if (p->rows > kMaxStageRows / unit * unit) p->rows = kMaxStageRows / unit * unit;
  if (p->groups * num_rows * width * 4 <= kTableBytes) {
    p->vt = num_rows;
    p->tiles = 1;
  } else {
    p->tiles = cdiv(num_rows, kTableBytes / (p->groups * width * 4));
    p->vt = cdiv(num_rows, p->tiles);
  }
  // The most warps an SM holds with at least 2 blocks on it; among equals,
  // the larger block (fewer partials).
  p->warps = 0;
  p->blocks_per_sm = 0;
  for (int min_blocks = 2; min_blocks >= 1 && p->warps == 0; --min_blocks) {
    for (long long w = 1; w <= kMaxWarps; ++w) {
      const long long bytes = block_smem(*p, w, width);
      if (bytes > kSmemPerBlock) break;
      long long b = kSmemPerSm / (bytes + kReservedPerBlock);
      if (b > 64 / w) b = 64 / w;
      if (b > kRegWarps / w) b = kRegWarps / w;
      if (b > 32) b = 32;
      if (b >= min_blocks && w * b >= p->warps * p->blocks_per_sm) {
        p->warps = w;
        p->blocks_per_sm = b;
      }
    }
  }
  if (p->warps == 0) return false;
  p->smem_bytes = block_smem(*p, p->warps, width);
  // About one wave of blocks, each reading at least its partial's bytes.
  const long long chunks_target = cdiv(kSms * p->blocks_per_sm, p->tiles);
  long long wt = cdiv(n, chunks_target * p->warps);
  const long long least = cdiv(cdiv(p->vt * width * 4, row_bytes), p->warps);
  if (wt < least) wt = least;
  if (wt < unit) wt = unit;
  p->warp_tokens = cdiv(wt, unit) * unit;
  p->chunk = p->warps * p->warp_tokens;
  p->chunks = n > 0 ? cdiv(n, p->chunk) : 1;
  const long long outputs = num_rows * width;
  long long cap = cdiv((long long)kSms * 2048, outputs);
  if (cap > kMaxSplits) cap = kMaxSplits;
  if (cap > p->chunks) cap = p->chunks;
  p->splits = 1;
  while (p->splits * 2 <= cap) p->splits *= 2;
  p->per_split = cdiv(p->chunks, p->splits);
  return true;
}

struct PartialArgs {
  const unsigned char* cot;  // [n, width] f32, 16-byte aligned
  const long long* codes;    // [n]
  float* partial;            // [chunks, num_rows, width]
  long long n, total_bytes, warp_tokens, chunk;
  int num_rows, width, lanes, groups, cols, rows, vt, warps, row_bytes;
};

// Loads one stage of a warp's range into registers: the cotangent bytes of
// rows [r0, r0 + nrows) as 16-byte vectors (lane + 32 k), the last vector of
// the tensor a word at a time where it is cut short, and their codes.
__device__ __forceinline__ void load_stage(const PartialArgs& a, long long r0, int nrows, int lane, uint4 (&vec)[4],
                                           long long (&code)[8]) {
  const long long b0 = r0 * a.row_bytes;
  const int nvec = (int)((nrows * (long long)a.row_bytes + 15) / 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      const long long off = b0 + 16LL * i;
      if (off + 16 <= a.total_bytes) {
        vec[k] = __ldcs(reinterpret_cast<const uint4*>(a.cot + off));
      } else {
        const unsigned* w = reinterpret_cast<const unsigned*>(a.cot + off);
        const int words = (int)((a.total_bytes - off) / 4);
        vec[k] = make_uint4(w[0], words > 1 ? w[1] : 0u, words > 2 ? w[2] : 0u, 0u);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = lane + 32 * k;
    if (r < nrows) code[k] = __ldcs(a.codes + r0 + r);
  }
}

__global__ void __launch_bounds__(256, 3) gather_rows_bwd_partial(PartialArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = a.width, L = a.lanes, G = a.groups;
  const int walkers = a.warps * G;
  const long long tfloats = (long long)a.vt * E;  // one walker's table
  const int v0 = blockIdx.y * a.vt;
  const int vt = min(a.vt, a.num_rows - v0);
  const long long table_bytes = (4LL * walkers * tfloats + 15) / 16 * 16;
  const int stage_bytes = a.rows * a.row_bytes;
  float* tables = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + table_bytes + (long long)warp * stage_bytes;
  int* scodes = reinterpret_cast<int*>(smem + table_bytes + (long long)a.warps * stage_bytes) + warp * a.rows;

  for (long long i = threadIdx.x; i < table_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const long long start = blockIdx.x * a.chunk + (long long)warp * a.warp_tokens;
  const long long end = min(start + a.warp_tokens, a.n);
  const int g = lane / L, j = lane % L;
  float* table = tables + (long long)(warp * G + g) * tfloats;
  const float* rows = reinterpret_cast<const float*>(stage);

  uint4 vec[4];
  long long code[8];
  if (start < end) load_stage(a, start, (int)min((long long)a.rows, end - start), lane, vec, code);
  int cur = -1;  // the table row of the run being summed in acc
  float acc[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) acc[k] = 0.f;
  for (long long r0 = start; r0 < end; r0 += a.rows) {
    const int nrows = (int)min((long long)a.rows, end - r0);
    __syncwarp();  // every lane is done with the previous stage
    const int nvec = (nrows * a.row_bytes + 15) / 16;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < nvec) reinterpret_cast<uint4*>(stage)[lane + 32 * k] = vec[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (lane + 32 * k < nrows) {
        if (code[k] < 0 || code[k] >= a.num_rows) __trap();  // a code outside [0, num_rows)
        scodes[lane + 32 * k] = (int)code[k];
      }
    }
    __syncwarp();
    if (r0 + a.rows < end) load_stage(a, r0 + a.rows, (int)min((long long)a.rows, end - r0 - a.rows), lane, vec, code);
    for (int r = g; r < nrows; r += G) {
      const int v = scodes[r] - v0;
      if ((unsigned)v >= (unsigned)vt) continue;  // another tile's row
      if (v != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int k = 0; k < kMaxCols; ++k)
            if (k < a.cols && j + k * L < E) table[cur * E + j + k * L] = acc[k];
        }
        cur = v;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k)
          if (k < a.cols && j + k * L < E) acc[k] = table[v * E + j + k * L];
      }
      const float* row = rows + (long long)r * E;
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k)
        if (k < a.cols && j + k * L < E) acc[k] += row[j + k * L];
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k)
      if (k < a.cols && j + k * L < E) table[cur * E + j + k * L] = acc[k];
  }
  __syncthreads();

  // The chunk's partial of this tile: the walkers' tables in walker order.
  float* out = a.partial + (long long)blockIdx.x * a.num_rows * E + (long long)v0 * E;
  for (long long i = threadIdx.x; i < (long long)vt * E; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < walkers; ++w) s += tables[w * tfloats + i];
    out[i] = s;
  }
}

// out[o] = the chunks' partials of output o summed in chunk order: `splits`
// threads each sum a fixed range of `per_split` chunks, then the first adds
// their sums in order.
__global__ void __launch_bounds__(kSumThreads)
    gather_rows_bwd_sum(const float* __restrict__ partial, float* __restrict__ out, long long outputs,
                        long long chunks, int splits, long long per_split) {
  __shared__ float sums[kSumThreads];
  const int per_block = kSumThreads / splits;
  const int o_local = threadIdx.x % per_block, s = threadIdx.x / per_block;
  const long long o = blockIdx.x * (long long)per_block + o_local;
  float acc = 0.f;
  if (o < outputs) {
    const long long c0 = s * per_split, c1 = min(c0 + per_split, chunks);
#pragma unroll 4
    for (long long c = c0; c < c1; ++c) acc += partial[c * outputs + o];
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  if (s == 0 && o < outputs) {
    float t = 0.f;
    for (int k = 0; k < splits; ++k) t += sums[k * per_block + o_local];
    out[o] = t;
  }
}

// A lane's two columns c, c + 1 of token t (0 where a column is past the
// row); `pair`: the row width is even, so the two are one 4-byte load.
__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* cot, long long t, int width, int c,
                                                    bool pair) {
  const __nv_bfloat16* p = cot + t * width + c;
  if (pair) return c < width ? __ldg(reinterpret_cast<const __nv_bfloat162*>(p)) : __float2bfloat162_rn(0.f);
  __nv_bfloat162 v = __float2bfloat162_rn(0.f);
  if (c < width) v.x = __ldg(p);
  if (c + 1 < width) v.y = __ldg(p + 1);
  return v;
}

struct OrderedShared {
  __nv_bfloat162 rows[2][kOrderedChunk][kOrderedCols / 2];  // two fills of the block's 64 columns
  int pos[kOrderedChunk];                                    // the fill's tokens of row v, in order
  unsigned step_mask[kOrderedChunk / 32];
  int count[2];
};

// Warps 1-7 (224 threads, named barrier 1): the tokens t0 .. t0 + 511 of row
// v into fill b: their positions in order (a ballot a 32 tokens, each step's
// prefix of the ones before), then their 64 columns, copied asynchronously.
__device__ __forceinline__ void ordered_fill(OrderedShared& sh, int b, const __nv_bfloat16* cot,
                                             const long long* codes, long long n, long long t0, int v, int num_rows,
                                             int width, int c0, bool pair) {
  constexpr int kSteps = kOrderedChunk / 32, kFillers = kOrderedWarps - 1;
  const int pw = (threadIdx.x >> 5) - 1, lane = threadIdx.x & 31, pt = threadIdx.x - 32;
  long long code[(kSteps + kFillers - 1) / kFillers];
#pragma unroll
  for (int i = 0; i < (kSteps + kFillers - 1) / kFillers; ++i) {
    const long long t = t0 + 32 * (pw + kFillers * i) + lane;
    code[i] = pw + kFillers * i < kSteps && t < n ? __ldg(codes + t) : 0;
  }
#pragma unroll
  for (int i = 0; i < (kSteps + kFillers - 1) / kFillers; ++i) {
    const int s = pw + kFillers * i;
    if (s < kSteps) {
      if (code[i] < 0 || code[i] >= num_rows) __trap();  // a code outside [0, num_rows)
      const unsigned m = __ballot_sync(0xffffffffu, code[i] == v && t0 + 32 * s + lane < n);
      if (lane == 0) sh.step_mask[s] = m;
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kFillers) : "memory");
  int total = 0;
  for (int s = 0; s < kSteps; ++s) {
    const unsigned m = sh.step_mask[s];
    if (s % kFillers == pw && ((m >> lane) & 1u))
      sh.pos[total + __popc(m & ((1u << lane) - 1u))] = 32 * s + lane;
    total += __popc(m);
  }
  if (pt == 0) sh.count[b] = total;
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kFillers) : "memory");
  // Asynchronous copies where a pair is one aligned word: no register waits
  // on them, so every copy of the fill is in flight at once.
  for (int i = pt; i < total * (kOrderedCols / 2); i += 32 * kFillers) {
    const int m = i / (kOrderedCols / 2), j = i % (kOrderedCols / 2), c = c0 + 2 * j;
    if (pair && c < width) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&sh.rows[b][m][j]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(cot + (t0 + sh.pos[m]) * width + c)
                   : "memory");
    } else {
      sh.rows[b][m][j] = load_pair(cot, t0 + sh.pos[m], width, c, pair);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Warp 0 of an ordered block: adds the `count` rows of fill b to its two
// running sums in order. With kRoundEach the sums are bf16 and each add is
// one bf16 add, rounded once: the same as the index form's f32 add rounded
// to bf16, since the exact sum of two bf16 values is an f32 value, or lies
// too close to the larger one for either rounding to leave it. Else f32.
template <bool kRoundEach>
__device__ __forceinline__ void ordered_add(const OrderedShared& sh, int b, int lane, __nv_bfloat162& acc16,
                                            float& s0, float& s1) {
  const int count = sh.count[b];
  for (int m = 0; m < count; m += 8) {
    __nv_bfloat162 g[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) g[q] = m + q < count ? sh.rows[b][m + q][lane] : __float2bfloat162_rn(0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (m + q < count) {
        if (kRoundEach) {
          acc16 = __hadd2(acc16, g[q]);
        } else {
          s0 += __low2float(g[q]);
          s1 += __high2float(g[q]);
        }
      }
    }
  }
}

// bf16 tables: out[v, c] = the tokens of row v in token order, each added in
// f32 to the running sum, rounded to bf16 after each add with kRoundEach,
// else at the end. A block a (row v = blockIdx.x, 64 columns blockIdx.y):
// warps 1-7 fill one buffer in shared memory with the row's cotangents of
// the next 512 tokens while warp 0, a lane two columns, adds those of the
// last fill in order.
template <bool kRoundEach>
__global__ void __launch_bounds__(32 * kOrderedWarps)
    gather_rows_bwd_ordered(const __nv_bfloat16* __restrict__ cot, const long long* __restrict__ codes,
                            __nv_bfloat16* __restrict__ out, long long n, int num_rows, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  OrderedShared& sh = *reinterpret_cast<OrderedShared*>(smem);
  const int v = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kOrderedCols;
  const bool pair = (width & 1) == 0;
  const long long fills = (n + kOrderedChunk - 1) / kOrderedChunk;
  __nv_bfloat162 acc16 = __float2bfloat162_rn(0.f);
  float s0 = 0.f, s1 = 0.f;
  if (warp > 0 && fills > 0) ordered_fill(sh, 0, cot, codes, n, 0, v, num_rows, width, c0, pair);
  __syncthreads();
  for (long long k = 0; k < fills; ++k) {
    const int b = (int)(k & 1);
    if (warp > 0) {
      if (k + 1 < fills) ordered_fill(sh, b ^ 1, cot, codes, n, (k + 1) * kOrderedChunk, v, num_rows, width, c0, pair);
    } else {
      ordered_add<kRoundEach>(sh, b, lane, acc16, s0, s1);
    }
    __syncthreads();
  }
  if (warp == 0) {
    if (kRoundEach) {
      s0 = __low2float(acc16);
      s1 = __high2float(acc16);
    }
    const int c = c0 + 2 * lane;
    __nv_bfloat16* o = out + (long long)v * width + c;
    if (c < width) o[0] = __float2bfloat16_rn(s0);
    if (c + 1 < width) o[1] = __float2bfloat16_rn(s1);
  }
}

}  // namespace

// The plan of n tokens of a [num_rows, width] f32 table, kPlanFields values
// in Plan's order, then the blocks of the partial pass an SM holds by the
// runtime's occupancy calculator. -1 where the kernels do not take the
// shape.
extern "C" int afr_gather_rows_plan(long long n, int num_rows, int width, long long* out) {
  Plan p;
  if (!make_plan(n, num_rows, width, &p)) return -1;
  const long long* f = &p.lanes;
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  int blocks = -1;
  if (cudaFuncSetAttribute(gather_rows_bwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_rows_bwd_partial, (int)(32 * p.warps),
                                                    (size_t)p.smem_bytes) != cudaSuccess)
    blocks = -1;
  out[kPlanFields] = blocks;
  return 0;
}

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): 0 when its launches were accepted. A code
// outside [0, num_rows) stops the kernel (a CUDA error at the next
// synchronisation).

// d(table) [num_rows, width] f32 of cot [n, width] f32 (16-byte aligned,
// contiguous) and codes [n] int64 in [0, num_rows); partial: f32 workspace
// of plan.chunks * num_rows * width.
extern "C" int afr_gather_rows_bwd(const float* cot, const long long* codes, float* partial, float* out, long long n,
                                   int num_rows, int width, void* stream) {
  Plan p;
  if (!make_plan(n, num_rows, width, &p)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(cot) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  PartialArgs a;
  a.cot = reinterpret_cast<const unsigned char*>(cot);
  a.codes = codes;
  a.partial = partial;
  a.n = n;
  a.total_bytes = n * width * 4;
  a.warp_tokens = p.warp_tokens;
  a.chunk = p.chunk;
  a.num_rows = num_rows;
  a.width = width;
  a.lanes = (int)p.lanes;
  a.groups = (int)p.groups;
  a.cols = (int)p.cols;
  a.rows = (int)p.rows;
  a.vt = (int)p.vt;
  a.warps = (int)p.warps;
  a.row_bytes = width * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(gather_rows_bwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  gather_rows_bwd_partial<<<dim3((unsigned)p.chunks, (unsigned)p.tiles), (unsigned)(32 * p.warps),
                            (size_t)p.smem_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outputs = (long long)num_rows * width;
  const long long per_block = kSumThreads / p.splits;
  gather_rows_bwd_sum<<<(unsigned)cdiv(outputs, per_block), kSumThreads, 0, st>>>(partial, out, outputs, p.chunks,
                                                                                (int)p.splits, p.per_split);
  return (int)cudaGetLastError();
}

// d(table) [num_rows, width] bf16 of cot [n, width] bf16 (4-byte aligned,
// contiguous) and codes [n] int64 in [0, num_rows), in the index form's
// arithmetic: rounded after every add where width > 32.
extern "C" int afr_gather_rows_bwd_ordered(const void* cot, const long long* codes, void* out, long long n,
                                           int num_rows, int width, void* stream) {
  if (n < 0 || num_rows <= 0 || width <= 0 || width > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(cot) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const int bytes = (int)sizeof(OrderedShared);
  const auto kernel = width > 32 ? gather_rows_bwd_ordered<true> : gather_rows_bwd_ordered<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)num_rows, (unsigned)cdiv(width, kOrderedCols));
  kernel<<<grid, 32 * kOrderedWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(cot), codes, static_cast<__nv_bfloat16*>(out), n, num_rows, width);
  return (int)cudaGetLastError();
}
