// Visited-set insert-if-absent for the batched device BFS.
//
// Replaces the JAX package's one TPU kernel, the partitioned-VMEM Pallas
// insert: stateright_tpu/tensor/pallas_hashtable.py::_make_kernel (kernel
// body) launched by _pallas_insert (XLA routing pre-pass + pl.pallas_call).
// That design sorted each batch into table partitions, pulled one partition
// at a time into VMEM and probed its keys serially, because the TPU has no
// scatter atomics; the spill/retry loop (MAX_RETRY_ROUNDS) existed because
// a partition's VMEM row block had a fixed width. Hopper has 64-bit
// atomicCAS on device memory, so none of that is carried over: one thread
// per active lane probes and claims in place.
//
// Table layout: one uint64 key array, key = hi << 32 | lo, where 0 marks an
// empty slot (real keys have lo != 0), and one int64 parent array beside it.
// The bucket function is the JAX kernel's, so occupancy and overflow behave
// the same: partition p = hi mod P, home bucket row (hi div P) mod (V/128)
// of 128 slots, and the probe chain runs on through the following rows,
// wrapping within the partition (V = S/P slots).
//
// Per active lane: scan the chain up to the first empty slot; the key found
// there means "present" (verdict 0). At the first empty slot, atomicCAS
// 0 -> key: a win stores the parent and marks the lane new (verdict 1); a
// loss to the same key means present; a loss to another key keeps scanning.
// A slot only ever goes from empty to one fixed key, and a claim only ever
// lands on the first empty slot of a chain, so the occupied slots of every
// chain stay a prefix of it: scanning to the first empty slot is exact, and
// every distinct key gets exactly one is_new per call. Which of several
// lanes offering the same key wins is not fixed. A chain with no empty slot
// (the whole partition full) sets *overflow (verdict 2); the caller aborts.
//
// What bounds it on the H100: each active lane reads its chain prefix,
// random 32-byte sectors of the key array (four slots per sector, read as
// two 16-byte loads through L2), plus its own 8-byte key and parent, and a
// win writes 16 bytes. The work is a few compares per slot, so the kernel is
// bound by device-memory sectors and their latency, not by operations.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kBucket = 128;  // slots per bucket row (the JAX kernel's)
constexpr int kThreads = 256;

__global__ void visited_insert_kernel(
    unsigned long long* t_key,  // [S] claimed with atomicCAS
    long long* t_parent,        // [S]
    const unsigned long long* __restrict__ key,     // [n]
    const long long* __restrict__ parent,           // [n]
    const unsigned char* __restrict__ active,       // [n] bool
    unsigned char* __restrict__ is_new,             // [n] bool out
    int* overflow,                                  // [1], zeroed by caller
    long long n,
    unsigned n_partitions,
    unsigned part_slots)  // V, a multiple of kBucket
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    is_new[i] = 0;
    if (!active[i]) return;

    const unsigned long long k = key[i];
    const unsigned hi = (unsigned)(k >> 32);
    const unsigned long long part_base =
        (unsigned long long)(hi % n_partitions) * part_slots;
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
            if (seen[q] == k) return;  // present
            if (seen[q] == 0ull) {
                // A stale empty read only costs a CAS that reports the truth.
                const unsigned long long old =
                    atomicCAS(part + pos + q, 0ull, k);
                if (old == 0ull) {
                    t_parent[part_base + pos + q] = parent[i];
                    is_new[i] = 1;
                    return;
                }
                if (old == k) return;  // another lane of this batch won
                // Lost to another key: the chain goes on past this slot.
            }
        }
        pos += 4;
        if (pos == part_slots) pos = 0;
    }
    *overflow = 1;  // the whole partition is full
}

}  // namespace

extern "C" int visited_insert(
    void* t_key, void* t_parent, const void* key, const void* parent,
    const void* active, void* is_new, void* overflow, long long n,
    long long n_partitions, long long part_slots, void* stream)
{
    if (n <= 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    visited_insert_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (unsigned long long*)t_key, (long long*)t_parent,
        (const unsigned long long*)key, (const long long*)parent,
        (const unsigned char*)active, (unsigned char*)is_new,
        (int*)overflow, n, (unsigned)n_partitions, (unsigned)part_slots);
    return (int)cudaGetLastError();
}

extern "C" const char* visited_insert_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
