// Visited-set insert-if-absent for the batched device BFS, in two forms: the
// plain insert (verdicts 0 present, 1 inserted, 2 chain full) and the fused
// Bloom-suspect form, which also marks a newly inserted key whose k probe
// bits are all set in the tiered store's summary (verdict 3, a suspect).
//
// Replaces the JAX package's one TPU kernel, the partitioned-VMEM Pallas
// insert: stateright_tpu/tensor/pallas_hashtable.py::_make_kernel (kernel
// body, the fused Bloom probe at its lines 246-266) launched by
// _pallas_insert (XLA routing pre-pass + pl.pallas_call). That design sorted
// each batch into table partitions, pulled one partition at a time into VMEM
// and probed its keys serially, because the TPU has no scatter atomics; the
// spill/retry loop (MAX_RETRY_ROUNDS) existed because a partition's VMEM row
// block had a fixed width. Hopper has 64-bit atomicCAS and atomicMin on
// device memory, so none of that is carried over: one thread per lane.
//
// Table layout: one uint64 key array, key = hi << 32 | lo, where 0 marks an
// empty slot (real keys have lo != 0), and one int64 parent array beside it,
// holding 0 (no parent) or a key. The bucket function is the JAX kernel's,
// so occupancy and overflow behave the same: partition p = hi mod P, home
// bucket row (hi div P) mod (V/128) of 128 slots, and the probe chain runs on
// through the following rows, wrapping within the partition (V = S/P slots).
//
// One call is three launches on the caller's stream:
//
// 1. probe_claim, per active lane: scan the chain up to the first empty
//    slot; the key found there means "present". At the first empty slot,
//    atomicCAS 0 -> key: a won CAS marks the slot fresh by storing the tag
//    (lane + 1) << 32 in its parent; a CAS lost to the same key lands on
//    that slot too; a CAS lost to another key keeps scanning. Each lane
//    records the slot its key was resolved to. A slot only ever goes from
//    empty to one fixed key, and a claim only ever lands on the first empty
//    slot of a chain, so the occupied slots of every chain stay a prefix of
//    it: scanning to the first empty slot is exact, and each distinct key is
//    claimed once per call. A chain with no empty slot (the whole partition
//    full) sets *overflow (verdict 2); the caller aborts.
// 2. elect, per resolved lane: if its slot holds a tag (low 32 bits 0, not
//    0 itself: no parent can look like that, a parent being 0 or a key),
//    atomicMin its own tag into it. The slot ends holding the tag of the
//    lowest lane that offered the key, whichever lane won the CAS.
// 3. decide, per lane: the lane whose tag the slot holds is the one new
//    lane of its key (verdict 1). It replaces the tag with its parent and,
//    with a summary, computes the Kirsch-Mitzenmacher pair h1, h2 from its
//    key's lo/hi in uint32 and tests the k probe bits (h1 + i*h2) mod 2^m of
//    the summary words (store/summary.py's layout): all set is verdict 3.
//
// So the new lane of each key is the lowest active lane offering it, the JAX
// kernel's serial attribution: is_new, suspect and the stored parents equal
// the plain torch version's lane for lane. Where two different keys race
// for one slot, which gets it is not fixed, so slot positions may differ.
//
// The tiered store's eviction (store/tiered.py) keeps the prefix invariant:
// it empties only whole 128-slot rows that are not full, or a whole
// partition. A claim only passes a row that is full at that moment, rows
// lose keys only to eviction, and the row sweep never touches a full row; so
// every row a stored key's chain passes stays full, an emptied row is all
// empty, and every chain is still "occupied prefix, then empty". A chain
// never leaves its partition, so emptying the partition empties the chain.
//
// What bounds it on the H100: each active lane reads its chain prefix,
// random 32-byte sectors of the key array (four slots per sector, read as
// two 16-byte loads through L2), plus its own 8-byte key and 1-byte flag;
// phases 2 and 3 read the lane's 8-byte slot index and one parent sector;
// a new key writes its parent and, fused, reads k summary words. The work
// is a few compares and a murmur mix per lane, so the kernel is bound by
// device-memory sectors and their latency, not by operations.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kBucket = 128;  // slots per bucket row (the JAX kernel's)
constexpr int kThreads = 256;

// murmur3 fmix32 and the double-hash constants of store/summary.py.
constexpr unsigned kM1 = 0x85EBCA6Bu;
constexpr unsigned kM2 = 0xC2B2AE35u;
constexpr unsigned kC1 = 0x9E3779B9u;
constexpr unsigned kC2 = 0x7F4A7C15u;

__device__ __forceinline__ long long tag_of(long long lane) {
    return (lane + 1) << 32;
}

__device__ __forceinline__ bool is_tag(long long v) {
    return v != 0 && (v & 0xFFFFFFFFll) == 0;
}

__device__ __forceinline__ unsigned fmix32(unsigned h) {
    h = (h ^ (h >> 16)) * kM1;
    h = (h ^ (h >> 13)) * kM2;
    return h ^ (h >> 16);
}

__global__ void probe_claim_kernel(
    unsigned long long* t_key,  // [S] claimed with atomicCAS
    long long* t_parent,        // [S] a won slot gets the lane's tag
    const unsigned long long* __restrict__ key,  // [n]
    const unsigned char* __restrict__ active,    // [n] bool
    long long* __restrict__ slot_of,             // [n] out: slot, or -1
    int* overflow,                               // [1], zeroed by caller
    long long n,
    unsigned n_partitions,
    unsigned part_slots)  // V, a multiple of kBucket
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    slot_of[i] = -1;
    if (!active[i]) return;

    const unsigned long long k = key[i];
    const unsigned hi = (unsigned)(k >> 32);
    const long long part_base = (long long)(hi % n_partitions) * part_slots;
    unsigned long long* part = t_key + part_base;
    unsigned pos = ((hi / n_partitions) % (part_slots / kBucket)) * kBucket;

    // pos stays a multiple of 4 (rows are 128 slots), so each group of four
    // slots is one aligned 32-byte sector.
    for (unsigned scanned = 0; scanned < part_slots; scanned += 4) {
        const ulonglong2* p2 = reinterpret_cast<const ulonglong2*>(part + pos);
        const ulonglong2 a = __ldcg(p2);
        const ulonglong2 b = __ldcg(p2 + 1);
        const unsigned long long seen[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const long long slot = part_base + pos + q;
            if (seen[q] == k) {  // present, or claimed earlier in this call
                slot_of[i] = slot;
                return;
            }
            if (seen[q] == 0ull) {
                // A stale empty read only costs a CAS that reports the truth.
                const unsigned long long old =
                    atomicCAS(part + pos + q, 0ull, k);
                if (old == 0ull) {
                    t_parent[slot] = tag_of(i);
                    slot_of[i] = slot;
                    return;
                }
                if (old == k) {  // another lane of this call claimed it
                    slot_of[i] = slot;
                    return;
                }
                // Lost to another key: the chain goes on past this slot.
            }
        }
        pos += 4;
        if (pos == part_slots) pos = 0;
    }
    *overflow = 1;  // the whole partition is full
}

__global__ void elect_kernel(
    long long* t_parent, const long long* __restrict__ slot_of, long long n)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long s = slot_of[i];
    if (s < 0) return;
    // During this launch a slot claimed in this call holds only tags, and
    // every other slot only its parent: the test cannot change under it.
    if (is_tag(__ldcg(t_parent + s))) {
        atomicMin(reinterpret_cast<unsigned long long*>(t_parent + s),
                  (unsigned long long)tag_of(i));
    }
}

__global__ void decide_kernel(
    long long* t_parent,
    const unsigned long long* __restrict__ key,  // [n]
    const long long* __restrict__ parent,        // [n]
    const long long* __restrict__ slot_of,       // [n]
    unsigned char* __restrict__ is_new,          // [n] bool out
    unsigned char* __restrict__ suspect,         // [n] bool out, or null
    const unsigned* __restrict__ summary,        // [2^(log2 - 5)], or null
    unsigned summary_mask,                       // 2^summary_log2 - 1
    int hashes,
    long long n)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    unsigned char fresh = 0, sus = 0;
    const long long s = slot_of[i];
    // Only the elected lane can see its own tag: the others see another
    // lane's tag, or the parent the elected lane wrote (never a tag).
    if (s >= 0 && __ldcg(t_parent + s) == tag_of(i)) {
        t_parent[s] = parent[i];
        fresh = 1;
        if (summary != nullptr) {
            const unsigned long long k = key[i];
            const unsigned h1 = fmix32((unsigned)k ^ kC1);
            const unsigned h2 = fmix32((unsigned)(k >> 32) ^ kC2) | 1u;
            sus = 1;
            for (int j = 0; j < hashes && sus; ++j) {
                const unsigned pos = (h1 + (unsigned)j * h2) & summary_mask;
                sus = (__ldg(summary + (pos >> 5)) >> (pos & 31u)) & 1u;
            }
        }
    }
    is_new[i] = fresh;
    if (suspect != nullptr) suspect[i] = sus;
}

}  // namespace

extern "C" int visited_insert(
    void* t_key, void* t_parent, const void* key, const void* parent,
    const void* active, void* slot_of, void* is_new, void* suspect,
    void* overflow, const void* summary, long long summary_log2,
    long long hashes, long long n, long long n_partitions,
    long long part_slots, void* stream)
{
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t st = (cudaStream_t)stream;
    probe_claim_kernel<<<blocks, kThreads, 0, st>>>(
        (unsigned long long*)t_key, (long long*)t_parent,
        (const unsigned long long*)key, (const unsigned char*)active,
        (long long*)slot_of, (int*)overflow, n, (unsigned)n_partitions,
        (unsigned)part_slots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    elect_kernel<<<blocks, kThreads, 0, st>>>(
        (long long*)t_parent, (const long long*)slot_of, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned mask = summary_log2 >= 32
        ? 0xFFFFFFFFu : (unsigned)((1ull << summary_log2) - 1);
    decide_kernel<<<blocks, kThreads, 0, st>>>(
        (long long*)t_parent, (const unsigned long long*)key,
        (const long long*)parent, (const long long*)slot_of,
        (unsigned char*)is_new, (unsigned char*)suspect,
        (const unsigned*)summary, mask, (int)hashes, n);
    return (int)cudaGetLastError();
}

extern "C" const char* visited_insert_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
