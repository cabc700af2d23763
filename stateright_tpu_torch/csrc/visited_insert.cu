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
// device memory, so none of that is carried over.
//
// Table layout: one uint64 key array, key = hi << 32 | lo, where 0 marks an
// empty slot (real keys have lo != 0), and one int64 parent array beside it,
// holding 0 (no parent) or a key. The bucket function is the JAX kernel's,
// so occupancy and overflow behave the same: partition p = hi mod P, home
// bucket row (hi div P) mod (V/128) of 128 slots, and the probe chain runs on
// through the following rows, wrapping within the partition (V = S/P slots).
//
// What bounds it on the H100. The work per lane is a few compares and a
// murmur mix: operations are nowhere near a limit. Each active lane must read
// its chain up to its key or the first empty slot, and with this bucket
// function a present key sits on average half way into its row's occupied
// prefix: ~33 slots in at half load (9.3 sectors of 32 bytes per lane),
// more at 0.85 fill. Those reads are random 32-byte sectors of a table far
// larger than L2, so two things bound the kernel: the latency of each
// dependent sector read, and the bytes of the whole prefix (the layout's
// scan floor, several times the must-move bound of one home sector per
// lane). Other bucket or slot functions would lower the floor but end
// slot-for-slot parity with the JAX table (from_jax_table / to_jax_table).
// The design below turns the dependent reads into a few wide ones (phase
// 1), so that what is left is the rate at which the card serves random
// reads of a few hundred bytes: a wider tile reads fewer rounds but more
// bytes, a narrower one the reverse (PERF.md has the trials of T = 4, 8
// and 16 threads a key; kTile = 8 was the fastest over both forms).
//
// One call is three launches on the caller's stream, each a grid of the
// blocks that fit on the card at once, in four phases. Block b owns the same
// contiguous range of the batch's lanes (a multiple of 128) in all three.
// Phases 0 and 1 are local to a block and share launch 1; phases 2 and 3
// each need every claim of the phase before, so each has a launch. (One
// cooperative launch with grid barriers was tried on the H100: it took as
// long on the device, but the engine, which queues 16 steps ahead of the
// card, then ran its steps in lock step with the card.)
//
// 0. compact: each thread reads four `active` flags, zeroes their is_new
//    (and suspect) bytes, and a warp scan plus one shared-memory atomicAdd
//    per warp place the active lanes' indices and keys densely at the start
//    of the block's range in the scratch arrays, and the count in
//    a.counts[b] for the later launches. From here on only active
//    lanes cost anything, and a call with no active lane is one pass over
//    the flags and the outputs. The list's order does not matter: a lane's
//    tag is its own index.
// 1. probe/claim: a tile of kTile threads (a cg::thread_block_tile) walks
//    one key's chain, one round per loop iteration. Each thread loads one
//    aligned 32-byte sector (four slots, two 16-byte __ldcg loads), so one
//    round reads 4 kTile consecutive chain slots at once instead of one
//    sector per dependent load. A tile ballot finds the first slot in chain order
//    that holds the key or is empty. Holding the key: present, or claimed
//    earlier in this call. Empty: one thread atomicCAS 0 -> key. A won CAS
//    stores the lane's tag (lane + 1) << 32 in the slot's parent; a CAS lost
//    to the same key resolves to that slot; a CAS lost to another key goes
//    on from the next slot, reading the window again. A slot only ever goes
//    from empty to one fixed key within a call, so a stale "empty" costs
//    only a CAS that reports the truth. A claim lands only on the first
//    empty slot of its chain, so the occupied slots of every chain stay a
//    prefix of it: stopping at the first empty slot is exact, and each
//    distinct key is claimed once per call. A walk that covers all V slots
//    of the partition resolves to -1: the chain is full. The tiles of a warp
//    run in lock step, one round of each tile's own key per loop iteration,
//    so a warp keeps 32/kTile chain reads in flight and no tile waits for
//    another's key. A tile that resolves a key takes the next unclaimed
//    entry of the block's list (a shared-memory counter), claimed and
//    loaded one key ahead, so tiles that meet long chains do not hold up
//    the block.
// 2. elect, per compacted lane: -1 sets *overflow (verdict 2; the caller
//    aborts). If its slot holds a tag (low 32 bits 0, not 0 itself: no
//    parent can look like that, a parent being 0 or a key), atomicMin its
//    own tag into it. The slot ends holding the tag of the lowest lane that
//    offered the key, whichever lane won the CAS. The CAS winner's tag store
//    races with lanes that find the key in phase 1, which is why electing
//    waits for the next launch. A lane whose slot holds no tag (its key was
//    present before the call) is marked settled in the scratch.
// 3. decide, per lane that phase 2 did not settle (a few percent of the
//    active lanes at a search step): the lane whose tag the slot holds is the
//    one new lane of its key (verdict 1). It replaces the tag with its
//    parent, sets its is_new byte and, with a summary, computes the
//    Kirsch-Mitzenmacher pair h1, h2 from its key's lo/hi in uint32 and
//    tests the k probe bits (h1 + i*h2) mod 2^m of the summary words
//    (store/summary.py's layout), all k word reads issued at once: all set
//    is verdict 3.
//
// Launch 1 zeroes *overflow itself (launch 2 is the first to set it), and
// nothing allocates: the caller passes the scratch (20 bytes a lane and 4
// for each 128, never initialised) and the outputs from torch.empty. Nothing
// here reads a count back to the host.
//
// So the new lane of each key is the lowest active lane offering it, the JAX
// kernel's serial attribution: is_new, suspect and the stored parents equal
// the plain torch version's lane for lane. Where two different keys race
// for one slot, which gets it is not fixed, so slot positions may differ;
// the set of occupied slots does not (as in any linear probing, it does not
// depend on the order of the claims), so every row's fill is the same.
//
// The tiered store's eviction (store/tiered.py) keeps the prefix invariant:
// it empties only whole 128-slot rows that are not full, or a whole
// partition. A claim only passes a row that is full at that moment, rows
// lose keys only to eviction, and the row sweep never touches a full row; so
// every row a stored key's chain passes stays full, an emptied row is all
// empty, and every chain is still "occupied prefix, then empty". A chain
// never leaves its partition, so emptying the partition empties the chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kBucket = 128;  // slots per bucket row (the JAX kernel's)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 8;  // 2048 threads: the SM's most
constexpr int kTile = 8;         // threads that probe one key together

// murmur3 fmix32 and the double-hash constants of store/summary.py.
constexpr unsigned kM1 = 0x85EBCA6Bu;
constexpr unsigned kM2 = 0xC2B2AE35u;
constexpr unsigned kC1 = 0x9E3779B9u;
constexpr unsigned kC2 = 0x7F4A7C15u;

struct Args {
    unsigned long long* t_key;    // [S] claimed with atomicCAS
    long long* t_parent;          // [S] a won slot holds the lane's tag until phase 3
    const unsigned long long* key;  // [n]
    const long long* parent;        // [n]
    const unsigned char* active;    // [n] bool
    int* clane;                   // [n] scratch: the active lanes of each block's range,
    unsigned long long* ckey;     //     their keys, and the slots they resolve to,
    long long* cslot;             //     densely from the start of the range
    int* counts;                  // [blocks] scratch: each block's count of them
    unsigned char* is_new;        // [n] bool out
    unsigned char* suspect;       // [n] bool out, or null
    unsigned char* overflow;      // [1] bool out
    const unsigned* summary;      // [2^(log2 - 5)] words, or null
    unsigned summary_mask;        // 2^summary_log2 - 1
    int hashes;
    long long n;
    unsigned n_partitions;
    unsigned part_slots;          // V, a multiple of kBucket
};

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

// The lanes of block b: [b * span, min(n, (b + 1) * span)).
__device__ __forceinline__ long long range_start(long long span) {
    return (long long)blockIdx.x * span;
}

// Phase 0. Returns the count of the block's active lanes, whose indices and
// keys now sit at a.clane/a.ckey[lo ...]. Ends with __syncthreads.
__device__ int compact_phase(const Args& a, long long lo, long long span, int* count)
{
    const int lane_id = threadIdx.x & 31;
    const long long hi = lo + span < a.n ? lo + span : a.n;
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
    for (long long g = lo + 128 * (threadIdx.x / 32); g < hi; g += 128 * kWarps) {
        const long long i = g + 4 * lane_id;
        unsigned flags = 0;  // bit q: lane i + q is active
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (i + q < a.n) {
                flags |= (unsigned)(a.active[i + q] != 0) << q;
                a.is_new[i + q] = 0;
                if (a.suspect != nullptr) a.suspect[i + q] = 0;
            }
        }
        const int mine = __popc(flags);
        int incl = mine;  // inclusive scan of the warp's counts
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (lane_id >= d) incl += v;
        }
        int base = 0;
        if (lane_id == 31 && incl) base = atomicAdd(count, incl);
        int j = __shfl_sync(0xFFFFFFFFu, base, 31) + incl - mine;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if ((flags >> q) & 1u) {
                a.clane[lo + j] = (int)(i + q);
                a.ckey[lo + j] = a.key[i + q];
                ++j;
            }
        }
    }
    __syncthreads();
    return *count;
}

// Where a key's chain lives: its partition's base slot and its home slot.
struct Chain {
    long long part_base;
    unsigned home;
};

__device__ __forceinline__ Chain chain_of(const Args& a, unsigned long long k) {
    const unsigned hi = (unsigned)(k >> 32);
    const unsigned V = a.part_slots;
    return {(long long)(hi % a.n_partitions) * V,
            ((hi / a.n_partitions) % (V / kBucket)) * kBucket};
}

// One entry of the block's list for a tile: the next unclaimed index.
template <class Tile>
__device__ __forceinline__ int claim(const Tile& tile, int* next) {
    int j = 0;
    if (tile.thread_rank() == 0) j = atomicAdd(next, 1);
    return tile.shfl(j, 0);
}

// Phase 1 over the block's m compacted lanes, a tile of kTile threads a key.
// Tiles claim keys from the block's list as they finish one (a shared
// counter), so a tile that meets long chains does not hold up the rest.
__device__ void probe_phase(const Args& a, long long lo, int m, int* next)
{
    cg::thread_block_tile<kTile> tile = cg::tiled_partition<kTile>(cg::this_thread_block());
    const unsigned r = tile.thread_rank();
    const unsigned V = a.part_slots;

    int j = threadIdx.x / kTile;  // this tile's entry of the list
    bool busy = j < m;
    int lane = busy ? a.clane[lo + j] : 0;
    unsigned long long k = busy ? a.ckey[lo + j] : 0;
    // The tile's next entry, claimed and loaded one key ahead.
    int j_next = claim(tile, next);
    int lane_next = j_next < m ? a.clane[lo + j_next] : 0;
    unsigned long long k_next = j_next < m ? a.ckey[lo + j_next] : 0;
    Chain c = chain_of(a, k);
    // Chain offsets below `from` are known to hold other keys. A window
    // starts on a sector (offsets are 4-aligned, home is 128-aligned), so
    // thread r's four slots are one aligned 32-byte sector.
    unsigned from = 0;

    while (__any_sync(0xFFFFFFFFu, busy)) {
        const unsigned off = (from & ~3u) + 4u * r;
        unsigned pos = 0, stop = 0, hit = 0;  // stop/hit: 4-bit slot masks
        if (busy && off < V) {
            pos = c.home + off;
            if (pos >= V) pos -= V;
            const ulonglong2* p2 =
                reinterpret_cast<const ulonglong2*>(a.t_key + c.part_base + pos);
            const ulonglong2 x = __ldcg(p2);
            const ulonglong2 y = __ldcg(p2 + 1);
            const unsigned long long seen[4] = {x.x, x.y, y.x, y.y};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (off + q < from) continue;
                hit |= (unsigned)(seen[q] == k) << q;
                stop |= (unsigned)(seen[q] == k || seen[q] == 0ull) << q;
            }
        }
        const unsigned who = tile.ballot(stop != 0);
        bool done = false;
        long long slot = -1;
        if (who != 0) {
            const unsigned leader = __ffs(who) - 1;
            int lost = 0;  // the leader lost its CAS to another key
            unsigned at = 0;
            if (r == leader) {
                const int q = __ffs(stop) - 1;
                slot = c.part_base + pos + q;
                at = off + q;
                if (!((hit >> q) & 1u)) {
                    const unsigned long long old = atomicCAS(
                        reinterpret_cast<unsigned long long*>(a.t_key) + slot, 0ull, k);
                    if (old == 0ull) {
                        a.t_parent[slot] = tag_of(lane);
                    } else if (old != k) {
                        lost = 1;
                    }
                }
            }
            lost = tile.shfl(lost, leader);
            slot = tile.shfl(slot, leader);
            at = tile.shfl(at, leader);
            if (lost) {
                from = at + 1;
            } else {
                done = true;
            }
        } else {
            from = (from & ~3u) + 4u * kTile;
        }
        if (busy && !done && from >= V) {  // the whole partition: full
            done = true;
            slot = -1;
        }
        if (busy && done) {
            if (r == 0) a.cslot[lo + j] = slot;
            j = j_next;
            busy = j < m;
            lane = lane_next;
            k = k_next;
            c = chain_of(a, k);
            from = 0;
            j_next = claim(tile, next);
            if (j_next < m) {
                lane_next = a.clane[lo + j_next];
                k_next = a.ckey[lo + j_next];
            }
        }
    }
}

// Phases 2 and 3 take up to kBatch list entries a thread at once, so that
// their loads are in flight together.
constexpr int kBatch = 4;
// cslot values beside a slot and -1 (a full chain): no entry, and an entry
// that phase 2 found on a slot holding no tag (a key present before the
// call), which phase 3 can skip without reading the table.
constexpr long long kNoEntry = -2;
constexpr long long kSettled = -3;

// Launch 1: phases 0 and 1, both local to the block. The block's count of
// active lanes goes to a.counts for the later launches.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
probe_kernel(Args a, long long span)
{
    __shared__ int count, next;
    const long long lo = range_start(span);
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.overflow = 0;
    if (threadIdx.x == 0) next = kThreads / kTile;  // the first claims are static
    const int m = compact_phase(a, lo, span, &count);
    if (threadIdx.x == 0) a.counts[blockIdx.x] = m;
    probe_phase(a, lo, m, &next);
}

// Launch 2, phase 2. During it a slot claimed in this call holds only tags,
// and every other slot only its parent, so the test cannot change.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) elect_kernel(Args a, long long span)
{
    const long long lo = range_start(span);
    const int m = a.counts[blockIdx.x];
    for (int j0 = threadIdx.x; j0 < m; j0 += kBatch * kThreads) {
        long long s[kBatch], p[kBatch];
        int lane[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int j = j0 + u * kThreads;
            s[u] = j < m ? a.cslot[lo + j] : kNoEntry;
            lane[u] = j < m ? a.clane[lo + j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) p[u] = s[u] >= 0 ? __ldcg(a.t_parent + s[u]) : 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (s[u] == -1) {
                *a.overflow = 1;
            } else if (s[u] >= 0 && is_tag(p[u])) {
                atomicMin(reinterpret_cast<unsigned long long*>(a.t_parent + s[u]),
                          (unsigned long long)tag_of(lane[u]));
            } else if (s[u] >= 0) {
                a.cslot[lo + j0 + u * kThreads] = kSettled;
            }
        }
    }
}

// Launch 3, phase 3, over the candidates of phase 2. Only the elected lane
// can see its own tag; the others see another lane's tag, or the parent the
// elected lane wrote (never a tag).
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) decide_kernel(Args a, long long span)
{
    const long long lo = range_start(span);
    const int m = a.counts[blockIdx.x];
    for (int j0 = threadIdx.x; j0 < m; j0 += kBatch * kThreads) {
        long long s[kBatch], p[kBatch];
        int lane[kBatch];
        bool fresh[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int j = j0 + u * kThreads;
            s[u] = j < m ? a.cslot[lo + j] : kNoEntry;
            lane[u] = j < m ? a.clane[lo + j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            fresh[u] = s[u] >= 0 && __ldcg(a.t_parent + s[u]) == tag_of(lane[u]);
            p[u] = fresh[u] ? a.parent[lane[u]] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (!fresh[u]) continue;
            a.t_parent[s[u]] = p[u];
            a.is_new[lane[u]] = 1;
            if (a.summary == nullptr) continue;
            const unsigned long long k = a.ckey[lo + j0 + u * kThreads];
            const unsigned h1 = fmix32((unsigned)k ^ kC1);
            const unsigned h2 = fmix32((unsigned)(k >> 32) ^ kC2) | 1u;
            unsigned all = 1u;
#pragma unroll 4
            for (int i = 0; i < a.hashes; ++i) {
                const unsigned pos = (h1 + (unsigned)i * h2) & a.summary_mask;
                all &= __ldg(a.summary + (pos >> 5)) >> (pos & 31u);
            }
            if (all & 1u) a.suspect[lane[u]] = 1;
        }
    }
}

// The three launches on the caller's stream. Blocks: as many as fit on
// the card at once (so that each block's list is long enough to balance
// its tiles), fewer when the batch has fewer 128-lane groups; each takes a
// range of `span` lanes, a multiple of 128.
cudaError_t launch(Args a, cudaStream_t st, long long* launches)
{
    static int resident[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, probe_kernel, kThreads, 0);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        resident[dev] = per_sm * sms;
    }
    const long long groups = (a.n + 127) / 128;
    const unsigned blocks = (unsigned)(groups < resident[dev] ? groups : resident[dev]);
    const long long span = (groups + blocks - 1) / blocks * 128;
    probe_kernel<<<blocks, kThreads, 0, st>>>(a, span);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    elect_kernel<<<blocks, kThreads, 0, st>>>(a, span);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    decide_kernel<<<blocks, kThreads, 0, st>>>(a, span);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launches;
    return cudaSuccess;
}

long long g_launches = 0;

}  // namespace

// One call, three launches. `scratch` holds 20 bytes a lane and 4 bytes for
// each 128 lanes. Returns a cudaError_t code (0 on success).
extern "C" int visited_insert(
    void* t_key, void* t_parent, const void* key, const void* parent,
    const void* active, void* scratch, void* is_new, void* suspect,
    void* overflow, const void* summary, long long summary_log2,
    long long hashes, long long n, long long n_partitions,
    long long part_slots, void* stream)
{
    if (n <= 0) return 0;
    Args a;
    a.t_key = (unsigned long long*)t_key;
    a.t_parent = (long long*)t_parent;
    a.key = (const unsigned long long*)key;
    a.parent = (const long long*)parent;
    a.active = (const unsigned char*)active;
    a.ckey = (unsigned long long*)scratch;
    a.cslot = (long long*)scratch + n;
    a.clane = (int*)((long long*)scratch + 2 * n);
    a.counts = a.clane + n;
    a.is_new = (unsigned char*)is_new;
    a.suspect = (unsigned char*)suspect;
    a.overflow = (unsigned char*)overflow;
    a.summary = (const unsigned*)summary;
    a.summary_mask = summary_log2 >= 32
        ? 0xFFFFFFFFu : (unsigned)((1ull << summary_log2) - 1);
    a.hashes = (int)hashes;
    a.n = n;
    a.n_partitions = (unsigned)n_partitions;
    a.part_slots = (unsigned)part_slots;
    return (int)launch(a, (cudaStream_t)stream, &g_launches);
}

// CUDA launches this library has made, in all (three per call with n > 0).
extern "C" long long visited_insert_launch_count(void)
{
    return g_launches;
}

extern "C" const char* visited_insert_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
