// Multi-threaded fixed-record gather for the packed crop cache (counterpart
// of simhand_tpu/native/batch_gather.cpp).
//
// Assembling a batch of crops (256 pairs x 224x224x3 uint8 = 77 MB) from
// memmapped shards is a pure memcpy problem that numpy's fancy indexing
// runs on one thread. This fans the record copies across OpenMP threads.
//
// Built at first use by simhand_tpu_torch.native (g++ -O3 -shared -fPIC
// -fopenmp) and called from simhand_tpu_torch.gather, which checks every
// index and buffer before it passes a pointer here.
#include <cstdint>
#include <cstring>

extern "C" {

// Copies n records of record_size bytes: dst[i] = src[indices[i]].
void gather_records(const uint8_t* src, const int64_t* indices, int64_t n,
                    int64_t record_size, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * record_size, src + indices[i] * record_size,
                static_cast<size_t>(record_size));
  }
}

// Records in shard shard_ids[i] at row rows[i]; srcs holds the shards' base
// pointers.
void gather_records_sharded(const uint8_t* const* srcs,
                            const int64_t* shard_ids, const int64_t* rows,
                            int64_t n, int64_t record_size, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * record_size,
                srcs[shard_ids[i]] + rows[i] * record_size,
                static_cast<size_t>(record_size));
  }
}

}  // extern "C"
