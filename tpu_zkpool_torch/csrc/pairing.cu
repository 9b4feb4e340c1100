// Pairing kernels P1 (k_miller_lines) and P2 (k_final_exp) for Hopper
// (sm_90a): the device side of the batched Groth16 verify, one warp a batch
// element, over BN254 Fp2 / Fp12 built on field.cuh's Fp.
//
// They replace no pl.pallas_call. The JAX package compiles
// tpu_zkpool/curve/pairing_jax.py:miller_loop_lines (l.412) and
// :final_exponentiation (l.305) into one XLA program (_ppl_jit); the port's
// FieldCtx would run the same work as ~1.5-2 million small torch kernels a
// batch, so each is one kernel here, with its plain torch version in
// tpu_zkpool_torch/curve/pairing.py (over curve/tower.py).
//
// P1 computes miller_loop_lines: for up to 3 legs, each a G1 point (px, py)
// and its precomputed line coefficients (curve/lines.py: alpha_neg = -lam
// and beta = lam t_x - t_y, per ATE step a double line and an add line,
// then two Frobenius end lines), f = 1; per step f = f^2, then each leg's
// double line, then where the ATE bit is set each leg's add line (the JAX
// scan computes both and selects: the same value); then the end lines. A
// line is l0 + l1 w + l3 w^3 with l0 = py, l1 = alpha_neg px, l3 = beta.
// P2 computes final_exponentiation: f^-1, then FE_PROGRAM of
// curve/pairing.py (the JAX _fe_program) step for step over 15 Fp12
// registers, its x-power ladders as loops over the bits of BN_X.
//
// What bounds them: one thread's Montgomery product is issue-bound (~1,300
// instructions, 0.61-0.67 us on the H100, field.cuh), and a pairing is a
// chain of Fp12 operations of 18 to 63 Fp products each. Run by one thread
// an element, as this source first did, each product waited on the one
// before it (17,604 a Miller loop). So a warp takes a batch element, and
// each Fp12 operation runs as a short lane program
// (curve/pairing_program.py): a MUL step computes up to 32 independent
// Fp products, one a lane, whose operands are integer combinations of
// slots (Karatsuba's sums); a LIN step computes up to 32 combinations (the
// recombination, the products by xi, the outputs); an INV step inverts one.
// Every operation but the inverse is one or two MUL steps and one LIN step
// (the product's long outputs two). The values live in the warp's shared
// memory, one slot (8 words) an Fp value, named by its index, so a lane
// reads any operand with two shared loads: no shuffles, no per-lane
// selects, one __syncwarp a step, and no Fp12 passed by value.
//
// What bounds a step (chip_smoke.py phase 10 and scripts/pairing_phase10.py
// time the kernels): one lane's product, then the latency of the
// combinations, a reduction each and about a term's loads and multiply-adds
// more for each term, then the step's own loads and sync. So the programs
// favour operands of one slot (a MUL step whose operands are all
// single slots skips the combination: the line product and the cyclotomic
// square and the Frobenius maps use schoolbook Fp2 products for it, which
// still fit their steps), short outputs (the square is schoolbook over w:
// 63 products in two steps, each output a few Fp2 products) and half sums
// on idle lanes for the product's outputs of 36 terms. A combination
// accumulates its word products in 64-bit words and is reduced once
// (combine); the one product is fp_mul_fast, out of line. The inverse's
// safegcd runs on every lane (on zero in all but one), so the warp stays
// converged and the step is branch-free like the others; it is one step of
// ~22.5 us a P2 call. P1 loads the lines of an ATE step, at most
// 2 kMaxLegs, in one round trip into staging slots.
//
// Every value is canonical Montgomery (R = 2^256), so every form gives the
// limbs of the plain version. Layout: Fp12 int64[B, 12, 16], row 2 i + c
// the component c of the coefficient of w^i (the JAX order); lines and
// points the port's int64 16-bit limbs. The lane programs come in one
// uint32 blob (curve/pairing_program.py documents its format), in global
// memory, read through the read-only cache: the terms of a step are read
// coalesced, term j of lane k at 32 j + k.
//
// Launch shape: kWarps = 2 warps (batch elements) a block. At the verify's
// batch of 256 on the H100, blocks of 1, 2 and 4 warps ran within 4% of
// each other and 2 gave the fastest P1 (PERF.md section 6).
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/curve/pairing_kernels.py) with the blob and its first
// free slot; the launcher adds the kernel's own slots (miller_slots,
// final_exp_slots) and sizes the dynamic shared memory from them; returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kLanes = 32;
constexpr int kMaxLegs = 3;
constexpr int kWarps = 2;  // warps (batch elements) a block
constexpr int kAteSteps = 64;
// 6x + 2 without its leading bit, step 0 at bit 63 (curve/lines.py ATE_BITS)
constexpr uint64_t kAteBits = 0x9d797039be763ba8ull;
// BN_X, the curve parameter, and its length in bits (fields/bn254.py)
constexpr uint64_t kBnX = 0x44e992b44a6909f1ull;
constexpr int kBnXBits = 63;

// The lane programs (pairing_program.OPS) and the slots they use
// (pairing_program.A, B, L, K): operand a and the result, operand b, a
// line (alpha_neg's two components, beta's two, px, py), the gammas.
enum { kSqr, kLine, kMul, kCyclo, kFrob1, kFrob2, kFrob3, kConj, kInv };
enum { kStepMul, kStepLin, kStepInv };
constexpr int kSlotA = 0, kSlotB = 12, kSlotL = 24, kSlotK = 30;
constexpr uint32_t kNoDst = 0xFFFF;
// the blob's word 1 (pairing_program.FORMAT): each kernel traps on another
// word rather than run a blob of another format
constexpr uint32_t kBlobFormat = 0x7A6B0001u;
// Slots a warp past the blob's first free slot: P1 stages an ATE step's
// lines (6 slots a line, at most 2 kMaxLegs lines), P2 holds FE_PROGRAM's
// kFeRegs Fp12 registers (curve/pairing.py FE_NREG), 12 slots each.
constexpr int kStageSlots = 6 * 2 * kMaxLegs;
constexpr int kFeRegs = 15;
constexpr int miller_slots(int first) { return first + kStageSlots; }
constexpr int final_exp_slots(int first) { return first + 12 * kFeRegs; }
// a warp's slots at most on the host, where shared memory is a static array
constexpr int kHostSlots = 512;

// Frobenius coefficients xi^(i (p^k - 1) / 6), k = 1, 2, 3, i = 0 .. 5, as
// Montgomery words (c0, c1) (refimpl/pairing_ref.py _gamma).
__device__ __constant__ uint32_t kGamma[3][6][2][8] = {
    {  // p^1
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x33144907u, 0xaf9ba696u, 0x87afb78au, 0xca6b1d73u, 0xf08a2087u, 0x11bded5eu, 0x1a1f3a7cu, 0x02f34d75u},
      {0x4c492d72u, 0xa222ae23u, 0x565de15bu, 0xd00f02a4u, 0x53dfc926u, 0xdc2ff3a2u, 0xb3899551u, 0x10a75716u}},
     {{0x4563ab30u, 0xb5773b10u, 0xa9aa6454u, 0x347f91c8u, 0x242e0991u, 0x7a007127u, 0x118214ecu, 0x1956bcd8u},
      {0xa0aa4757u, 0x6e849f1eu, 0x89f89141u, 0xaa1c7b6du, 0xfae0ca3au, 0xb6e713cdu, 0x4e82ebc3u, 0x26694fbbu}},
     {{0x2936b629u, 0xe4bbdd0cu, 0xe133bacbu, 0xbb30f162u, 0xf9645366u, 0x31a9d1b6u, 0xa500f8ddu, 0x253570beu},
      {0x5ffe77c7u, 0xa1d77ce4u, 0x7826d1dbu, 0x07affd11u, 0xbb7edc6bu, 0x6d16bd27u, 0x85defeccu, 0x2c872002u}},
     {{0x843abe92u, 0x7361d77fu, 0x273411fbu, 0xa5bb2bd3u, 0x4b3e2399u, 0x9c941f31u, 0xbb9fd3ecu, 0x15df9cddu},
      {0x4bd8c949u, 0x5dddfd15u, 0xa4445b60u, 0x62cb29a5u, 0x0c7dd2b9u, 0x37bc870au, 0x3171f0fdu, 0x24830a9du}},
     {{0x41690fe7u, 0xc970692fu, 0x27694b0bu, 0xe2403421u, 0x83c459e8u, 0x32bee66bu, 0x0ab08841u, 0x12aabcedu},
      {0x40aebfa9u, 0x0d485d23u, 0xab2fcc57u, 0x05193418u, 0x8a4910f5u, 0xd3b0a40bu, 0x35d2925au, 0x2f21ebb5u}}},
    {  // p^2
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x00fa1bf2u, 0xca8d8005u, 0x68b39769u, 0xf0c5d614u, 0xad0d4418u, 0x0e201271u, 0xbad856e6u, 0x04290f65u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x13e80b9cu, 0x3350c88eu, 0xdb5e56b9u, 0x7dce557cu, 0xb615564au, 0x6001b4b8u, 0x020217e0u, 0x2682e617u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x12edefaau, 0x68c34889u, 0x72aabf4fu, 0x8d087f68u, 0x09081231u, 0x51e1a247u, 0x4729c0fau, 0x2259d6b1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0xd782e155u, 0x71930c11u, 0xffbe3323u, 0xa6bb947cu, 0xd4741444u, 0xaa303344u, 0x26594943u, 0x2c3b3f0du},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0xc494f1abu, 0x08cfc388u, 0x8d1373d4u, 0x19b31514u, 0xcb6c0213u, 0x584e90fdu, 0xdf2f8849u, 0x09e1685bu},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}},
    {  // p^3
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x4e46d97du, 0x36531618u, 0xd4c96d9fu, 0x0af7129eu, 0xca1009b5u, 0x659da72fu, 0x83a20d23u, 0x08116d89u},
      {0xc39c1939u, 0xb1df4af7u, 0x8a73bf7fu, 0x3d9f0287u, 0x8caf0ae0u, 0x9b222092u, 0xeff054a6u, 0x26684515u}},
     {{0x16ad6badu, 0xc9af22f7u, 0x4aa662b2u, 0xb311782au, 0xe248c7f4u, 0x19eeaf64u, 0xe3439f82u, 0x20273e77u},
      {0xf7ce93acu, 0xacc02860u, 0x7ba76b4cu, 0x3933d581u, 0x446c8467u, 0x69e6188bu, 0x4417cc55u, 0x0a46036du}},
     {{0xaf46471eu, 0x5764af0au, 0x873e0fc1u, 0xdc50792eu, 0x881d04f6u, 0x86a673ffu, 0x3c30a74cu, 0x0b2eddb4u},
      {0x787e8580u, 0x9a490f32u, 0xf04af8b1u, 0x8fd16d7fu, 0xc6027bf2u, 0x4b39888eu, 0x5b52a15du, 0x03dd2e70u}},
     {{0x7b6762dfu, 0x448a93a5u, 0x28fdeadfu, 0xbfd62df5u, 0x0e9bd47au, 0xd858f5d0u, 0x3476ec58u, 0x06b03d4du},
      {0xbcc936d1u, 0x2b19daf4u, 0x56f4299fu, 0xa1a54e7au, 0x5adeaef1u, 0xb533eee0u, 0x84dda0b2u, 0x170c812bu}},
     {{0x75cf559fu, 0xe0bc4b22u, 0xc154e60fu, 0xc238b945u, 0x929a7d5eu, 0x803982a5u, 0xf7e4a37eu, 0x15ce052du},
      {0xbf3799a7u, 0x2d28efbdu, 0x1ad60773u, 0x9b097e3cu, 0xaf4a535bu, 0x982d4113u, 0xe3056063u, 0x24e18991u}}}
};

// 2^15 p, words 0 .. 8 (pairing_program.BIAS_LOG2): added to a combination
// so that it is non-negative before its reduction.
__device__ __constant__ uint32_t kBias[9] = {
    0x7ea38000u, 0x460b6c3eu, 0xe5469e10u, 0xb548b438u, 0xac2ecbc0u,
    0x22db40c0u, 0xd014dc28u, 0x27397098u, 0x00001832u};
// p >> 224, the top word of p
constexpr uint32_t kPTop = 0x30644e72u;

// ---------------------------------------------------------------- slots

// The block's dynamic shared memory, `slots` slots a warp, each two uint4;
// slots are named by their index in it, so every access is a shared load
// or store (a pointer into it passed to a function out of line would be a
// generic one).
ZK_DYNAMIC_SHARED(uint4, kSmem, kWarps * kHostSlots * 2);

__device__ __forceinline__ Fp slot_load(uint32_t i) {
  const uint4 x = kSmem[2 * i], y = kSmem[2 * i + 1];
  Fp r;
  r.v[0] = x.x, r.v[1] = x.y, r.v[2] = x.z, r.v[3] = x.w;
  r.v[4] = y.x, r.v[5] = y.y, r.v[6] = y.z, r.v[7] = y.w;
  return r;
}

__device__ __forceinline__ void slot_store(uint32_t i, const Fp& a) {
  kSmem[2 * i] = {a.v[0], a.v[1], a.v[2], a.v[3]};
  kSmem[2 * i + 1] = {a.v[4], a.v[5], a.v[6], a.v[7]};
}

// 12 slots from src to dst, half a slot a lane (lanes 0 .. 23); the caller
// syncs.
__device__ __forceinline__ void copy12(uint32_t dst, uint32_t src,
                                       int lane) {
  if (lane < 24) kSmem[2 * dst + lane] = kSmem[2 * src + lane];
}

// ------------------------------------------------------ lane programs

// sum_j c_j slot(s0 + t_j) mod p over this lane's n terms, canonical; term
// j is the word t[32 j] = t_j | |c_j| << 16 | (c_j < 0) << 31. A negative
// term is |c| (2^256 - 1 - v) + |c| - |c| 2^256, so every word product
// |c| v_i or |c| ~v_i is non-negative and goes into a 64-bit accumulator
// (sum |c_j| < 2^15: each stays below 2^48), the |c| into word 0 and the
// -|c| 2^256 into the top. One carry chain then gives X = sum + 2^15 p in
// [0, 2^16 p), whose quotient by p is estimated from its top 46 bits,
// X >> 224, over kPTop + 1: at most one short, so X - q p is below 2p and
// one conditional subtraction ends it.
__device__ __forceinline__ Fp combine(const uint32_t* __restrict__ t, int n,
                                      uint32_t s0) {
  uint64_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = kBias[i];
  uint32_t negs = 0;  // sum of |c_j| over the negative terms
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const uint32_t term = __ldg(t + kLanes * j);
    const Fp v = slot_load(s0 + (term & 0xFFFFu));
    const uint32_t c = (term >> 16) & 0x7FFFu;
    const uint32_t neg = (uint32_t)((int32_t)term >> 31);  // c_j < 0: ~0
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] += (uint64_t)c * (v.v[i] ^ neg);
    negs += c & neg;
  }
  Fp x;
  uint64_t acc = w[0] + negs;
  x.v[0] = (uint32_t)acc;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    acc = (acc >> 32) + w[i];
    x.v[i] = (uint32_t)acc;
  }
  // X >> 256, in [0, 2^14)
  const uint64_t top = (acc >> 32) + kBias[8] - negs;
  const uint64_t q = ((top << 32) | x.v[7]) / ((uint64_t)kPTop + 1);
  uint64_t cq = 0;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t m = q * FpMod::p(i) + cq;
    cq = m >> 32;
    const int64_t d = (int64_t)x.v[i] - (uint32_t)m + borrow;
    x.v[i] = (uint32_t)d;
    borrow = d >> 32;
  }
  return mont_reduce_once(x);
}

// Runs lane program `op` of the blob on the warp's slots from s0; every
// lane of the warp calls it.
__device__ __noinline__ void run(const uint32_t* __restrict__ blob, int op,
                                 uint32_t s0, int lane) {
  const uint32_t* p = blob + __ldg(blob + 2 + op);
  const int n = (int)__ldg(p++);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t h = __ldg(p);
    const int kind = h & 0xFF, na = (h >> 8) & 0xFF, nb = (h >> 16) & 0xFF;
    const uint32_t dst = __ldg(p + 1 + lane);
    const uint32_t* t = p + 1 + kLanes + lane;
    Fp x;
    if (h >> 24) {  // a MUL step of single slots: nothing to combine
      x = fp_mul_fast(slot_load(s0 + (__ldg(t) & 0xFFFFu)),
                      slot_load(s0 + (__ldg(t + kLanes) & 0xFFFFu)));
    } else {
      x = combine(t, na, s0);
      if (kind == kStepMul)
        x = fp_mul_fast(x, combine(t + kLanes * na, nb, s0));
      else if (kind == kStepInv)
        x = fp_inv(x);
    }
    if (dst != kNoDst) slot_store(s0 + dst, x);
    __syncwarp();
    p += 1 + kLanes * (1 + na + nb);
  }
}

// This warp's batch element b and its first slot, or -1 for a warp past
// the batch (it exits whole). A blob of another format traps.
__device__ __forceinline__ int warp_slots(const uint32_t* blob, int slots,
                                          int batch, int& b) {
  if (__ldg(blob + 1) != kBlobFormat) __trap();
  const int warp = threadIdx.x / kLanes;
  b = blockIdx.x * kWarps + warp;
  return b < batch ? slots * warp : -1;
}

// ------------------------------------------------------------------ P1

// The kernel's parameters, by value: per leg the G1 point's rows, its 12
// line arrays in LineArrays order (dbl an0, an1, b0, b1; add ...; end ...)
// and their batch stride in limbs (0: one row a step shared by the batch,
// the arrays [S, 16]; 16: [S, B, 16]).
struct MillerArgs {
  const int64_t* px[kMaxLegs];
  const int64_t* py[kMaxLegs];
  const int64_t* line[kMaxLegs][12];
  long long stride[kMaxLegs];
  int legs;
  int batch;
};

// Value j of line i of a group of n lines into staging slot stage + 6 i +
// j (alpha_neg's two components, beta's two, px, py), one load a lane for
// the whole group: line i is leg i % legs of part part0 + 4 dpart m at step
// st0 + dstep m, m = i / legs (parts: 0 dbl, 4 add, 8 end).
__device__ __forceinline__ void load_lines(const MillerArgs& a, int n,
                                           int part0, int dpart, int st0,
                                           int dstep, int b, uint32_t stage,
                                           int lane) {
  Fp v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = lane + kLanes * r, i = k / 6, j = k % 6;
    if (k >= 6 * n) continue;
    const int l = i % a.legs, m = i / a.legs;
    const int part = part0 + 4 * dpart * m, st = st0 + dstep * m;
    const long long stride = a.stride[l];
    const int64_t* q =
        j < 4 ? a.line[l][part + j] +
                    st * (stride ? (long long)a.batch * 16 : 16) + b * stride
              : (j == 4 ? a.px[l] : a.py[l]) + 16 * (long long)b;
    v[r] = fp_load(q);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (lane + kLanes * r < 6 * n) slot_store(stage + lane + kLanes * r, v[r]);
  __syncwarp();
}

// f times the n staged lines, one after another: each copied into the L
// slots (half a slot a lane), then the line program.
__device__ __forceinline__ void lines(const uint32_t* blob, int n,
                                      uint32_t stage, uint32_t s0, int lane) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (lane < 12)
      kSmem[2 * (s0 + kSlotL) + lane] = kSmem[2 * (stage + 6 * i) + lane];
    __syncwarp();
    run(blob, kLine, s0, lane);
  }
}

__global__ void __launch_bounds__(kLanes * kWarps)
    k_miller_lines(const MillerArgs args, const uint32_t* __restrict__ blob,
                   int slots, int64_t* out) {
  int b;
  const int s0 = warp_slots(blob, slots, args.batch, b);
  if (s0 < 0) return;
  const int lane = threadIdx.x % kLanes;
  // the staging slots of a step's lines (at most 2 kMaxLegs) follow the
  // programs' temporaries
  const uint32_t stage = s0 + __ldg(blob);
  if (lane < 12) slot_store(s0 + kSlotA + lane, lane ? fp_zero() : fp_one());
#pragma unroll 1
  for (int st = 0; st < kAteSteps; ++st) {
    // the double lines, then where the bit is set the add lines
    const int n = args.legs * (1 + ((kAteBits >> (kAteSteps - 1 - st)) & 1));
    load_lines(args, n, 0, 1, st, 0, b, stage, lane);
    run(blob, kSqr, s0, lane);
    lines(blob, n, stage, s0, lane);
  }
  load_lines(args, 2 * args.legs, 8, 0, 0, 1, b, stage, lane);
  lines(blob, 2 * args.legs, stage, s0, lane);
  if (lane < 12)
    fp_store(out + 192 * (long long)b + 16 * lane,
             slot_load(s0 + kSlotA + lane));
}

// ------------------------------------------------------------------ P2

// FE_PROGRAM's registers r0 .. r14, 12 slots each from slot r0 (the blob's
// word 0, the first slot after the programs' temporaries).
struct FeWarp {
  const uint32_t* blob;
  int s0, r0, lane;

  __device__ int reg(int i) const { return s0 + r0 + 12 * i; }

  // r[dst] = op(r[a], r[b]) (b < 0: a unary op)
  __device__ __noinline__ void op(int prog, int a, int b, int dst) const {
    copy12(s0 + kSlotA, reg(a), lane);
    if (b >= 0) copy12(s0 + kSlotB, reg(b), lane);
    __syncwarp();
    run(blob, prog, s0, lane);
    copy12(reg(dst), s0 + kSlotA, lane);
    __syncwarp();
  }

  // r[dst] = r[src]^BN_X by cyclotomic squares from the bit after the
  // leading one (FE_PROGRAM's pow_x), in the A slots, r[src] in B
  __device__ __noinline__ void pow_x(int src, int dst) const {
    copy12(s0 + kSlotA, reg(src), lane);
    copy12(s0 + kSlotB, reg(src), lane);
    __syncwarp();
#pragma unroll 1
    for (int i = kBnXBits - 2; i >= 0; --i) {
      run(blob, kCyclo, s0, lane);
      if ((kBnX >> i) & 1) run(blob, kMul, s0, lane);
    }
    copy12(reg(dst), s0 + kSlotA, lane);
    __syncwarp();
  }
};

__global__ void __launch_bounds__(kLanes * kWarps)
    k_final_exp(const int64_t* f, const uint32_t* __restrict__ blob,
                int slots, int64_t* out, int batch) {
  int b;
  const int s0 = warp_slots(blob, slots, batch, b);
  if (s0 < 0) return;
  const int lane = threadIdx.x % kLanes;
  const FeWarp fe{blob, s0, (int)__ldg(blob), lane};
  const uint32_t* gamma = &kGamma[0][0][0][0];
#pragma unroll 1
  for (int i = lane; i < 36; i += kLanes) {
    Fp g;
#pragma unroll
    for (int w = 0; w < 8; ++w) g.v[w] = gamma[8 * i + w];
    slot_store(s0 + kSlotK + i, g);
  }
  if (lane < 12)
    slot_store(fe.reg(0) + lane,
               fp_load(f + 192 * (long long)b + 16 * lane));
  __syncwarp();
  fe.op(kInv, 0, -1, 1);  // r1 = f^-1
  // easy part: r2 = f^(p^6 - 1), then m = r2^(p^2) r2
  fe.op(kConj, 0, -1, 2);
  fe.op(kMul, 2, 1, 2);
  fe.op(kFrob2, 2, -1, 1);
  fe.op(kMul, 1, 2, 2);
  // x-power ladder: fx, fx2, fx3
  fe.pow_x(2, 3);
  fe.pow_x(3, 4);
  fe.pow_x(4, 5);
  // y terms: r6 = y0, r7 = y1, r8 = y2, r9 = y3, r10 = y4, r11 = y5,
  // r12 = y6
  fe.op(kFrob1, 2, -1, 6);
  fe.op(kFrob2, 2, -1, 7);
  fe.op(kMul, 6, 7, 6);
  fe.op(kFrob3, 2, -1, 7);
  fe.op(kMul, 6, 7, 6);
  fe.op(kConj, 2, -1, 7);
  fe.op(kFrob2, 4, -1, 8);
  fe.op(kFrob1, 3, -1, 9);
  fe.op(kConj, 9, -1, 9);
  fe.op(kFrob1, 4, -1, 10);
  fe.op(kMul, 3, 10, 10);
  fe.op(kConj, 10, -1, 10);
  fe.op(kConj, 4, -1, 11);
  fe.op(kFrob1, 5, -1, 12);
  fe.op(kMul, 5, 12, 12);
  fe.op(kConj, 12, -1, 12);
  // Scott et al. combine
  fe.op(kCyclo, 12, -1, 12);
  fe.op(kMul, 12, 10, 12);
  fe.op(kMul, 12, 11, 12);
  fe.op(kMul, 9, 11, 13);
  fe.op(kMul, 13, 12, 13);
  fe.op(kMul, 12, 8, 12);
  fe.op(kCyclo, 13, -1, 13);
  fe.op(kMul, 13, 12, 13);
  fe.op(kCyclo, 13, -1, 13);
  fe.op(kMul, 13, 7, 14);
  fe.op(kMul, 13, 6, 13);
  fe.op(kCyclo, 14, -1, 14);
  fe.op(kMul, 14, 13, 14);
  if (lane < 12)
    fp_store(out + 192 * (long long)b + 16 * lane,
             slot_load(fe.reg(14) + lane));
}

}  // namespace zk

extern "C" {

int miller_args_size() { return (int)sizeof(zk::MillerArgs); }

int miller_lines(const zk::MillerArgs* args, const uint32_t* blob, int first,
                 int64_t* out, void* stream) {
  if (args->legs < 1 || args->legs > zk::kMaxLegs || args->batch < 1 ||
      first < 1)
    return (int)cudaErrorInvalidValue;
  const int slots = zk::miller_slots(first);
  const int blocks = (args->batch + zk::kWarps - 1) / zk::kWarps;
  zk::k_miller_lines<<<blocks, zk::kLanes * zk::kWarps,
                       (size_t)zk::kWarps * slots * 32,
                       (cudaStream_t)stream>>>(*args, blob, slots, out);
  return (int)cudaGetLastError();
}

int final_exp(const int64_t* f, const uint32_t* blob, int first,
              int64_t* out, int batch, void* stream) {
  if (batch < 1 || first < 1) return (int)cudaErrorInvalidValue;
  const int slots = zk::final_exp_slots(first);
  const int blocks = (batch + zk::kWarps - 1) / zk::kWarps;
  zk::k_final_exp<<<blocks, zk::kLanes * zk::kWarps,
                    (size_t)zk::kWarps * slots * 32, (cudaStream_t)stream>>>(
      f, blob, slots, out, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
