// guppi_repack: GUPPI raw words -> the two plane-packed word planes that
// K1p (`k1_packed`, csrc/dedisperse.cu) reads.
//
// Replaces no TPU kernel: the JAX package decodes GUPPI payloads on the
// host or in plain XLA (`io/guppi.py`), and its fused flagship entry takes
// only plane-packed words.  This pass lets the fused entry read a GUPPI
// block as the recorder wrote it.
//
// In: one block of a GUPPI node, channel-major (n_chan, T) 32-bit words,
// word (c, t) the bytes (X re, X im, Y re, Y im) of channel c's sample t,
// each a signed 8-bit value (NPOL = 4, NBITS = 8).  Out: the real and the
// imaginary plane, each (T/4, 2 n_chan) words, lane 2c + p (p = 0 for X,
// 1 for Y); byte k of word r is sample k T/4 + r of its lane (the
// plane-packed layout of `ops/unpack.pack_time_planes`), with its sign
// bit flipped: signed v becomes the offset-binary byte v + 128, which K1p
// decodes exactly with its offset argument of 128.
//
// What bounds it on an H100: bytes, each input word read once and both
// planes written once, 8 bytes a (channel, sample): 102.8 MB a step at
// the GUPPI deployment's 64 x 200,704 samples, 0.031 ms at 3.35 TB/s.
// The design is a transpose through shared memory: a block stages the
// four time planes of a tile of 32 plane rows by 32 channels (each warp
// reads 32 consecutive words of one channel), then each thread gathers
// one lane's four bytes per plane and the warp writes 32 consecutive
// lanes of a row.  The staging row is padded to 33 words, so the gather's
// reads (lanes of neighbouring channels) fall in different banks.

#include <cuda_runtime.h>

namespace bbt {

constexpr int kRepackRows = 32;    // plane rows r of a tile
constexpr int kRepackChans = 32;   // channels of a tile
constexpr int kRepackWarps = 8;

__global__ void __launch_bounds__(32 * kRepackWarps)
guppi_repack_kernel(const unsigned* __restrict__ in,
                    unsigned* __restrict__ re, unsigned* __restrict__ im,
                    int n_chan, int tq) {
  __shared__ unsigned tile[4][kRepackChans][kRepackRows + 1];
  const int r0 = blockIdx.x * kRepackRows;
  const int c0 = blockIdx.y * kRepackChans;
  const long t = 4L * tq;            // samples of a channel
  const int x = threadIdx.x, y = threadIdx.y;
  // stage: word (c0 + c, k tq + r0 + x) into tile[k][c][x]
  for (int i = y; i < 4 * kRepackChans; i += kRepackWarps) {
    const int k = i / kRepackChans, c = i % kRepackChans;
    const int r = r0 + x, ch = c0 + c;
    unsigned w = 0u;
    if (r < tq && ch < n_chan)
      w = in[ch * t + static_cast<long>(k) * tq + r];
    tile[k][c][x] = w;
  }
  __syncthreads();
  // gather: lane 2c + p of row r takes byte 2p (re) and 2p + 1 (im) of
  // the four staged words of (c, r)
  const int lanes = 2 * kRepackChans;
  const long row_words = 2L * n_chan;
  for (int i = y * 32 + x; i < kRepackRows * lanes; i += 32 * kRepackWarps) {
    const int lane = i % lanes, row = i / lanes;
    const int c = lane >> 1, p = lane & 1;
    const int r = r0 + row;
    if (r >= tq || c0 + c >= n_chan) continue;
    unsigned wr = 0u, wi = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned w = tile[k][c][row] >> (16 * p);
      wr |= (w & 0xffu) << (8 * k);
      wi |= ((w >> 8) & 0xffu) << (8 * k);
    }
    const long at = r * row_words + 2L * c0 + lane;
    re[at] = wr ^ 0x80808080u;
    im[at] = wi ^ 0x80808080u;
  }
}

}  // namespace bbt

// `words`: (n_chan, 4 tq) words; `re`, `im`: (tq, 2 n_chan) words.
extern "C" int bbt_guppi_repack(const void* words, void* re, void* im,
                                int n_chan, int tq, int device,
                                void* stream) {
  if (n_chan < 1 || tq < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + bbt::kRepackRows - 1) / bbt::kRepackRows,
                  (n_chan + bbt::kRepackChans - 1) / bbt::kRepackChans);
  bbt::guppi_repack_kernel<<<grid, dim3(32, bbt::kRepackWarps), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<unsigned*>(re),
      static_cast<unsigned*>(im), n_chan, tq);
  return cudaGetLastError();
}
