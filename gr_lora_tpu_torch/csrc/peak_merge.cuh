// The merge of the fused peak lattices K1 (rdft_spectra.cu) and K2
// (overlap_spectra.cu), defined in peak_topm.cu.
//
// Their product kernels leave, per row (a hop of a lane), L lists of M
// candidates (one a tile of the row's bins: a band of the sheared walk, a
// run of pair tiles of the rDFT product), each sorted best first and
// ended by an entry of value -inf where it holds fewer than M; and P pairs
// of deferred edge bins: two neighbouring bins whose tiles differ, each
// with its bin where it beat the threshold and its neighbour inside its
// own tile, else -1.  The merge resolves each pair (an entry is a peak
// where its test passed and it beats the other entry) and takes the row's
// top M by value, ties to the lower bin; unfilled slots hold bin 0, zero
// heights and valid 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace peaks {

struct Cand {
    float v;      // faw
    int b;        // bin (-1: a deferred bin whose own test failed)
    float h;      // fa
    float hs;     // hs
};

constexpr int kMaxM = 16;          // the fused searches' M at most

__host__ __device__ inline bool better(const Cand& a, const Cand& b) {
    return a.v > b.v || (a.v == b.v && a.b < b.b);
}

// Insert into a list of m candidates sorted best first (the fused
// searches' per-row lists in shared memory, one lane at a time).
__device__ inline void insert(Cand* list, int m, const Cand& c) {
    if (!better(c, list[m - 1])) return;
    int pos = m - 1;
    while (pos > 0 && better(c, list[pos - 1])) {
        list[pos] = list[pos - 1];
        --pos;
    }
    list[pos] = c;
}

// lists: [rows, nlists, m]; pairs: [rows, npairs, 2] (nullptr for 0).
int launch_merge(const Cand* lists, int nlists, const Cand* pairs,
                 int npairs, long long rows, int m, int* bins, float* h,
                 float* h_single, uint8_t* valid, cudaStream_t stream);

}  // namespace peaks
