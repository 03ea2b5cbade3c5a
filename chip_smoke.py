"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the Hopper kernels of ``baseband_tasks_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel, into ``build/kernels/``), then, at the
flagship configuration of ``bench.py`` (64 channels x 2 pols at 250 kHz,
DM 500, 64 phase bins, a B1937-like polyco, 8-bit plane-packed ingest;
window N = 2^18, L = 128 lanes):

(a) holds each flagship kernel against its plain PyTorch version on the
    same random input at the flagship shapes, and times both (K1 and K2
    beside their earlier designs' recorded times, their register forms
    asserted: K1's at every path's column, flagship, config 2 and
    config 3);
(b) drives the pipeline's entry points, ``run_fn(8, ingest_bits=8)`` and
    the float32 twin ``run_fn(2)``, with ``use_kernels=True``, checks the
    counts, checks the profiles against the plain versions on the card, and
    checks that every kernel was launched;
(c) times one pipeline step, kernels against the plain versions;

and at the coherent-dedispersion configuration of ``BASELINE.json``
config 2 (``tools/bench_full.py`` ``config2``: 128 channels x 125 kHz
around 1400 MHz, sideband +1, DM 29.7, noise from seed 1):

(d) holds the four-step kernels (k1_window, k2_fwd, k2_inv, k3_trim)
    against their plain versions at N = 2^18, L = 128 (pads 512/512 for
    the trim, both ortho settings for the FFT), and times both;
(e) drives the stream-task paths: ``Dechannelize(Dedisperse(src, 29.7,
    samples_per_frame=2**17, engine='pallas'))`` and ``Dedisperse(src,
    29.7, samples_per_frame=2**18 - 693, engine='xla')`` under
    ``fft_maker.set('pallas')``; reads a few frames of each, checks the
    geometry, that every kernel of each path was launched, and holds the
    output against the same chain on the plain versions on the card;
(f) times one frame of the first path, kernels against plain;

and for the compiled pipelines (``models/compiled.py``), at the full
width of ``BASELINE.json`` config 3 (``tools/bench_full.py`` ``config3``:
a 2^24-sample dual-pol 4 MHz noise source, seed 2; an 8-tap x 256-channel
sinc-Hamming PFB with 32256-spectrum frames and its Wiener inverse, sn 30,
pads 128/128 rounded to 256/256 rows of a 2^15-row window, L = 512
lanes) and of config 2:

(g) holds the compiled slice's kernels against their plain versions at
    the shapes those paths give them: pfb_fwd without and with its
    in-kernel DFT (32256 x 512, 8 taps; the fused DFT timed beside the
    FIR then lane_mix, one complex ``matmul`` of the tap sums by F and
    both of its bounds), k1_stream without and with the
    ``pre`` lane mix (2^15 x 512), k3_trim with the ``post`` lane mix
    (2^18 x 128), lane_mix (3xTF32 on the tensor cores) alone at the
    ``pre`` shape and at config 2's ``post`` shape (261,120 x 128), and
    against float64 at 4096 x L for L 128, 512, 1600 (within 1e-5 of
    the peak); and times both, lane_mix beside one complex ``matmul`` at
    both shapes and beside its 3xTF32 tensor-core and FP32-core bounds;
(h) drives four compiled paths through ``CompiledPipeline.planes_step``:
    the config-3 round trip (the quad fusion), config 2 compiled
    (``_FusedDisperseDechan``), and the two single fusions at config 3's
    widths (the forward PFB with its DFT; Dechannelize -> inverse PFB on
    a stream of spectra, with ``pre``).  For each: the fusion and the
    geometry, that each of its kernels was launched, its output against
    the same pipeline on the plain versions on the card (1e-4 of the
    peak, with and without a per-block scale), and against the port's
    eager chain: sample k against eager sample k - delay, held to rtol
    1e-3, atol 2e-3 for the chain as built (config 2 only reported: its
    frames sit off its pads, and the chirp's overlap-save leakage is
    outside that bound in the JAX package too) and where the eager frames
    fall on the compiled windows; then config 3, the forward PFB, config
    2 and Dechannelize -> inverse PFB timed in ms per block over a block
    already on the card, in turns, and profiled;

and for the flagship's variants, at the flagship configuration again:

(i) holds the variants' kernels (the full-Stokes fold k3_fold_stokes,
    k3_power, k2_theta on the chirp phase plane, k1_planes,
    k1_stream_planes) against their plain versions on the same random
    input at the shapes the flagship paths give them (N = 2^18, L = 128),
    and times both (k2_theta, k1_planes and k1_stream_planes beside their
    earlier designs' recorded times, their register forms asserted); at
    the GUPPI full-Stokes node's shapes (``benchmark/configs/
    guppi_b1937_stokes.json``) holds guppi_repack on one (64, 200,704)
    block of GUPPI words bit for bit against its plain version, and K3
    Stokes at 2048 bins over 128 lanes of the 2^18 window (pads 32,768 /
    28,672; its 4-lane, shared-partials general form asserted) against
    its plain version, both timed;
(j) drives the variants' entry points at full width, each with its
    launches counted and asserted: ``run_fn(8, ingest_bits=8)`` with
    ``detect='stokes'``, ``step_fn`` (power and Stokes) on a polyco fold
    row, ``step_bins_fn`` on ``phase_bins`` from the polyco,
    ``planes_step`` (``dedisperse_fold_stream`` with the cos/sin chirp;
    with the phase-plane chirp and Stokes) and ``dedisperse_fold_pow2``;
    holds each against the same call on the plain versions on the card
    (counts exact, summing to steps x block) and times both in turns;
    profiles one turn of ``run_fn`` Stokes (wall, device busy, time per
    kernel) and times one call that also builds it; then holds
    ``step_fn`` on the kernels against its torch.fft path (``use_kernels=False, fft_pow2=True``, no
    kernel launched) to the JAX package's rtol 1e-3 / atol 1e-2; and
    drives the GUPPI node's entry, ``run_fn(1, ingest_bits=8)`` with
    ``ingest_layout='guppi'`` on a block of device words (guppi_repack,
    K1p, K2 and K3 Stokes once each), against the same call on the plain
    versions, timed;

and for the searches and the single-pass resident op, at the acceleration
search of ``tools/bench_full.py`` ``accel()`` (a 2^22-sample series at
1 MHz, z_max 64 step 2: 65 trials) and at the flagship's width for the
resident op (L = 128, 64 phase bins, the DM-500 chirp within a channel,
pads 256/256, the 261,120-row block of ``tools/bench_resident.py``):

(k) holds bank_power (8448 x 512 segments against the 512 x 16896
    Karatsuba operator of the mx engine; 3xTF32 on the tensor cores),
    accel_corr (547 segments of 4096 against the search's 65 used lanes,
    and the public op at its 128 lanes beside both lane counts' bounds) and
    resident (windows 2048 and 4096, power and Stokes) against their
    plain versions, and times them beside the one PyTorch call computing
    the same function (a complex ``matmul`` and ``|.|^2``; cuFFT's
    inverse FFT of the bank product and ``|.|^2``; resident, in its
    register form, beside its shared-memory design's recorded time),
    bank_power beside its
    3xTF32 tensor-core and FP32-core bounds and against float64 on 256
    rows (within 1e-5 of the peak);
(l) runs ``FourierDomainAccelSearch.search`` on a seeded series (noise, a
    mid-band tone drifting 12 bins, a pulse train) with 'auto' (which
    must be 'pallas' on the card: accel_corr launched, no bank_power),
    'mx' by name (bank_power), 'pallas' (seg_len 4096) and 'xla' (8192),
    asserts each engine's launches, holds mx, auto and pallas against xla
    at the JAX package's bounds, finds the tone at every engine's map
    peak and with 'auto''s ``harmonic_sum`` and ``candidates``, times each engine against its
    plain versions in turns and ``search_sharded`` 'pallas' over four
    virtual shards of the card, then runs ``FastFoldingSearch`` (base period
    1000, 4096 trials) on the card against the same call on the CPU;
(m) calls ``ops.dedisperse_fold_resident`` on both engines, power and
    Stokes, against its plain versions on the card, and against the
    three-pass ``dedisperse_fold_split`` on the same block (one 2^18
    window) to 5e-4 of the peak, on an FIR inside the pads (where
    overlap-save is exact at both window sizes) and on the DM-500 chirp
    (whose tails leak past the 256-row pads, ~1e-4 of the peak); then
    both timed in turns, and whether the resident op beats the chain
    printed.

and for the bf16-intermediate mode of the flagship's split ops and the
integration layer:

(n) holds each bf16 pass (k1_packed_bf16, k1_float_bf16, k2_bf16 with a
    float32 chirp, k2_bf16_chirp with a bf16 one, k3_fold_bf16,
    k3_fold_stokes_bf16) against its plain bf16 version at the flagship
    shapes (planes within one bf16 ulp plus 1e-6 of the peak, counts
    exact, profiles as in (a) and within 1e-3 of the peak of the float32
    kernel), times each beside its float32 twin (the K1 and K2 forms also
    beside their earlier designs' recorded times, their register forms
    asserted); then drives
    ``dedisperse_fold_split`` and ``dedisperse_fold_split_packed`` with
    ``inter_dtype='bfloat16'`` (power and Stokes, float32 and bf16
    chirps), counted, against the plain bf16 path and the float32 op
    (1e-3 of the peak), and times float32 against bf16 per window;
(o) runs BASELINE config 1 (``tools/bench_full.py`` config1:
    Channelize(256) -> Square -> Integrate(16) of 16 MHz noise, seed 7)
    eagerly on the card over 2^22 samples and compiled through
    ``CompiledPipeline.run_reduced`` under ``fft_maker.set('pallas')`` in
    2^23-sample blocks, compiled against eager (rtol 1e-5, counts exact),
    both timed; then the masked fold of ``_fold_chain_rate`` (16 float32
    blocks of 2^14 x 128 -> Square -> Fold(64)) through ``run_reduced``,
    masked on blocks with NaN cells and unmasked, each against the eager
    Fold (counts and NaN cells exact), timed against each other.

and for the mesh (``parallel``), on meshes whose every shard lives on
the one card (``make_mesh(..., devices=[cuda:0] * k)``), so that reads
between cards are neither made nor timed here:

(p) holds halo_remote (``csrc/halo.cu``) against its plain version, the
    copies of ``halo='ppermute'``, on four shards at the flagship's
    shapes (float planes of 253,952 x 128, (T, 64, 2, 2) float32 pairs,
    complex64; pads 3584/4608), non-periodic and periodic, bit for bit,
    and times both beside the bound;
(q) drives the sharded flagship at full width (64 ch x 2 pol, DM 500,
    the polyco, N = 2^18 a shard): ``run_fn(8, ingest_bits=8)`` on
    (time=4, chan=1) and (2, 2), launches counted, against the plain
    versions; the halo kernel's path, float ``run_fn(2)`` with
    ``halo='remote'`` (two halo_remote launches a step), its edges bit
    for bit and its profiles against ``halo='ppermute'``; ``step_fn`` on
    both paths, 'remote' bit for bit against 'ppermute' (one launch a
    step); a dm=0 step against the closed-form numpy fold (rtol 2e-3,
    atol 0.05); (4, 2) against (4, 1) (rtol 1e-6, atol 1e-3);
    ``search_sharded`` ('pallas', 'mx') and ``snr_sharded`` on four shards
    against ``search()`` / ``snr()``; then the sharded packed step timed
    against one shard's, and the float step with each halo backend.

and for the slice of convolution, resampling, incoherent dispersion and
multi-input compiled graphs:

(r) compiles the FX correlator and the tied-array beamformer of
    ``tools/bench_full.py`` correlator() and beamform() at full width
    (16 MHz complex noise stations, 256 channels, method 'phase'; the
    correlator 2 stations at tau = 37.25 samples with n_avg 256 absorbed,
    the beamformer 4 stations at (11.25 + 7k) samples, coherent), runs 8
    blocks of 2^21 samples a station (one block tensor a station),
    holds the first two blocks against the eager stream (rtol 1e-3, atol
    2e-3) and the autocorrelations or beam power against the noise's
    level, and times them (ms per block, station samples/s).  No kernel
    of the port runs: the F stage is a 256-point torch.fft, and the
    correlator's 3 baselines x 256 channels are too few for the fused X
    stage (``CompiledPipeline.x_form`` 'products', asserted);
(s) drives ``ShiftAndResample(engine='pallas')`` on config 2's source
    (per-channel delays linspace(0.1, 0.9, 128) samples, LO 1400 MHz, pad
    64, frames of 261,632 samples: a 2^18 window, the 128-sample pad
    rounded to one 512-row N2 block), asserting the engine and the
    register forms: eagerly (k1_window, k2, k3_trim a frame) and compiled
    through ``planes_step`` (k1_stream, k2, k3_trim a block), launches
    counted exactly, each against the plain versions (1e-4 of the
    peak), the compiled blocks against the eager frames, then both timed;
(t) reads ``DedisperseSamples`` (DM 29.7) eagerly on config 1's detected
    filterbank (16 MHz noise labelled 1400 MHz, Channelize(256), Square)
    against the per-channel shifts applied to the filterbank, and times a
    frame.

and for stored baseband, at BASELINE config 4 (``tools/bench_full.py``
config4_packed(): 16 VDIF threads of 8-bit complex noise at 2^18 Hz, rng
seed 11, channel i at 1400 + 0.262144 (i // 2) MHz, Dedisperse(29.7) ->
Square -> Integrate(4096); 'auto' is 'pallas' on the card: a 2^17 window,
pads 512/512, blocks of 130,048 samples, file frames of 1024), the file
written by the port's VDIF writer into a temporary directory:

(u) runs ``StreamRunner`` over 6 blocks with packed ingest (the words
    shipped through the pinned ring, decoded on the card in ``step_fn``:
    k1_window, k2, k3_trim a block) and with float ingest (the host LUT
    decode, planes through ``planes_step``: k1_stream, k2, k3_trim a
    block), launches counted exactly; holds packed against float (rtol
    1e-4, atol 1e-6, counts exact), each against the same runner on the
    plain versions, and the bins against the eager chain read through
    the VDIF reader (rtol 1e-3, atol 2e-3); then streams 48 blocks (~200
    MB of packed payload) with each, in turns, and prints packed and
    float samples/s, the host decode rate (``native.unpack_8bit``), the
    bytes across the boundary per block, the time by layer (host read,
    H2D through the pinned ring, decode, the path's kernels at config
    4's 16 lanes against their plain versions, the reduction) and a
    profiled run with the card's busy share; then decodes one Mark 5B,
    DADA and GUPPI file each on the card from ``read_packed`` against
    the host decode, bit for bit.

and for the tasks and search models beyond the reference, on the paths
their users run:

(v1) the FRB search of ``examples/frb_search.py`` (16 MHz complex noise
    around 800 MHz with a burst at raw sample 200,000, 2^20 samples where
    the example's 2^19 give fewer spectra than the search's 4096) ->
    Disperse(26.7, 'pallas') -> Channelize(128) -> Square, its launches
    counted (k1_window, k2, k3_trim once a frame) and ``monitor()``'s
    seconds held against CUDA events around the same frames; the
    filterbank through the SIGPROC writer and ``open`` (bit for bit),
    ``DMTrialSearch`` (121 trials to DM 60, 4096 spectra) ``detect``,
    ``candidates`` and ``search_stream`` recovering the burst within the
    example's tolerances, the map against the chain on the plain
    versions (1e-4 of the peak), ``search_sharded`` on four shards of the
    card (1e-5), search and detect timed beside the tables' bytes bound,
    and a ``trace()`` of one search;
(v2) BASELINE polarization (``tools/bench_full.py`` polarization(): 64
    blocks of 2^18 dual-pol samples, Channelize(128) ->
    ConvertPolarization('circular') -> ApplyJones(inverse=True) -> Square
    -> Integrate(64)) compiled with and without the two pol stages,
    against the eager chain (rtol 1e-3, atol 2e-3, counts exact): samples/s
    and pol_overhead;
(v3) ``examples/calibrated_fold.py``'s chain at (v2)'s width (ApplyJones
    and its inverse -> Channelize(128) -> ExciseSpectralKurtosis(64, NaN
    fill) -> Square -> Fold(32, masked), 16 blocks): compiled against
    eager flag for flag, the RFI channel, contrast and unbiased mean as the
    example asserts them, the flagged share, a TOA by
    ``ProfileTemplate.toa``, timed;
(v4) DeFaraday(100 rad/m^2, linear) behind a 'pallas' Dedisperse(500)
    on the flagship's band (64 channels x 2 pols at 250 kHz) -> Square ->
    Integrate(1024), compiled: ``planes_step`` with k1_stream, k2,
    k3_trim and DeFaraday's ``task_planes`` once a block, against the
    complex step and the plain versions (1e-4 of the peak), timed;
(v5) BASELINE rmsearch: ``RMSynthesis.fdf`` of (4096, 1024) Q/U planes at
    1024 depths, timed beside its operations bound, 64 rows against
    float64 and ``fdf_sharded`` on four shards (1e-5 of the peak);
(v6) BASELINE secondary: ``secondary_spectrum`` of a (4096, 2048)
    dynamic spectrum against float64 (1e-5 of the peak), timed.

and for the time-sharded compiled graphs and the stored-file formats
(``models/sharded.py``, ``compile(mesh=)``, ``io/hdf5``, ``io/psrfits``),
on four virtual shards of the card along 'time':

(w1) config 2 compiled (Dechannelize(Dedisperse(29.7, 'pallas')), 128 x
    125 kHz) through ``ShardedPipeline`` for 8 blocks, against the
    one-device ``CompiledPipeline`` on the same blocks (rtol 1e-6), the
    pads checked against the per-shard block (the refusal's condition),
    both runs' launches equal (the complex step: k1_window, k2, k3_trim,
    lane_mix a block), both timed in ms a block, the sharded run
    profiled;
(w2) the same for config 3's PFB round trip (the quad fusion; its
    source lengthened to 2^26 samples for 8 blocks of 8,257,536);
(w3) ``compile(mesh=)`` of config 2 read whole on a source of 9.5
    blocks: two super-steps compiled, the warm-up and the remainder
    served eagerly (bit for bit against the eager chain), the compiled
    part against the one-device view (rtol 1e-6), and the compiled
    windows of block 1 against the eager chain to (h)'s bound;
(w4) (v1)'s filterbank through an 8-bit search-mode PSRFITS file (rows
    of 1024) and back onto the card (within half a level step), with
    ``DMTrialSearch`` recovering the burst from it; the flagship's
    ``run_fn(2)`` profile through a fold-mode file and back (within one
    16-bit level of a channel's range);
(w5) where ``h5py`` imports: an 8-bit HDF5 file of config 4's shape, its
    ``read_packed`` words decoded on the card bit for bit against the
    host read, and packed Dedisperse(29.7) -> Square over the four
    shards against the one-device float path (rtol 1e-5, atol 1e-6);
    without ``h5py``, the payload coding at 8, 4 and 2 bits decoded on
    the card against the host decode with no file.  No kernel's launch
    count depends on (w5);

and across two processes on the one card (``parallel.multihost``: two
workers of ``baseband_tasks_tpu_torch.tools.multihost_check`` running
:func:`multihost_worker_checks`, joined over gloo with the transfers
staged through pinned host memory, 2 virtual shards of ``cuda:0``
each; NCCL refuses two ranks on one card):

(x1) the flagship at full width, ``run_fn(8, ingest_bits=8)`` on a (4, 1)
    mesh split 2 + 2: each process launches k1_packed, k2 and k3_fold 16
    times, the counts exact and the profiles within PROFILE_RTOL of
    (q)'s one-process (4, 1) run; ms a step beside (q)'s, with the
    transport's bytes and host ms a step; ``step_fn`` on (2, 2) against
    one process;
(x2) config 2 compiled through ``ShardedPipeline`` over the two
    processes (S = 4, 8 blocks): every output block bit for bit against
    (w1)'s one-process sharded output (SHA-256 of its bytes), the two
    processes' launches summed equal to (w1)'s; ms a block beside (w1)'s;
(x3) ``search_sharded`` ('pallas', accel_corr), ``snr_sharded``,
    ``DMTrialSearch.search_sharded`` and ``fdf_sharded`` split over the
    two processes against the same calls in one process;
(x4) ``halo='remote'`` across the two processes: the halo_remote
    kernel's push form writes each crossing edge into the other
    process's memory through CUDA IPC, the streams ordered by flags in
    device memory (no transport call carries an edge).  The remote_*
    cases of ``multihost_check`` (small shapes; (4, 1), (2, 2), chan
    across, a ring whole beside one across; open and periodic) bit for
    bit against one process and 'ppermute'; the float ``run_fn(8)`` at
    full width on (4, 1) split 2 + 2: edges bit for bit against
    'ppermute', k1_float, k2, k3_fold 16 and halo_remote 32 launches a
    process, profiles within PROFILE_RTOL of (q)'s one-process 'remote'
    run and of 'ppermute', the transport's bytes a step only the
    profiles' gather; ms a step beside 'ppermute' in the same workers,
    (x1) and (q), each process's device work and the card's idle share;
    ``step_fn`` on (2, 2) bit for bit against 'ppermute' (2 halo_remote
    launches a process) and against one process.

and for the LOFAR HBA correlator node (``benchmark/configs/
lofar_hba_cobalt.json``: 62 stations x 2 pol, 30 subbands of 64
channels, dumps of 3072 spectra in blocks of 64):

(y) builds the node's compiled chain at full width and takes one
    block's stack (the X stage's input, at the strides the chain gives
    it) from its step: ``xcorr`` on it (the lead block's segment ids)
    against its plain version and the unfused path at the node's measure
    (a visibility's gap over sqrt(V_ii^pp V_jj^qq), under 4e-5; the plain
    version on the stack rounded to bf16 is held to fail it), bit for bit
    from call to call, one launch a call; timed beside the plain
    version, the unfused path (``CrossMultiply.task`` and the
    reduction's ``index_add_``) and its operations bound; then one dump
    through ``run_fn`` (49 blocks, ``CompiledPipeline.x_form`` 'fused'),
    one ``xcorr`` launch a block and no other kernel of the port, against
    the same run on the plain versions at the same measure.

The plain versions run on the card inside the package's test-only
switch ``ops.dedisperse.plain_versions()``, with every float32 matmul
in full float32 (``allow_tf32 = False``, precision 'highest', set and
printed before the comparisons).  Any failure raises (non-zero
exit).  Without a CUDA device it fails.  The
second-to-last line is a JSON object of per-kernel results; the last line
is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import peaks

# float32 FFT roundoff over log2(512) radix-2 stages is ~1e-6 of the
# largest element; an indexing or decode fault gives errors of order 1.
FFT_TOL = 1e-4            # max |kernel - plain| / max |plain|, K1/K2
TF32X3_TOL = 1e-5         # lane_mix, bank_power against float64, of the peak
# profile bins sum ~4000 detected samples per lane in a run-dependent
# (atomic) order; float32 summation noise is ~1e-6 relative
PROFILE_RTOL = 2e-4       # elementwise, K3 and the end-to-end profiles
N_ITER = 8

N_FRAMES = 2               # frames read from each stream-task path
# compiled output k against eager k - delay: the streaming windows sit
# off the eager frames (frames do not divide the pads), so they agree to
# the overlap-save leakage, not to roundoff (the JAX package's
# `_compare_eager` bound, tests/test_compiled_fusion.py)
EAGER_RTOL, EAGER_ATOL = 1e-3, 2e-3
# the paths held to that bound as built; config 2's chirp leaks past its
# 512-sample pads by more (~60 dB down by design, Disperse's pad_margin),
# in the JAX package as in the port: tests/test_torch_compiled.py
# test_config2_geometry_eager_gap
EAGER_AS_BUILT = ("config3_quad", "pfb_forward", "dechan_inverse")
N_STEPS = 8                # compiled steps per timed turn
# what bounds a kernel (`bound_ms`): the benchmark's peaks (the H100 SXM
# data sheet's HBM rate and FP32 rate outside the tensor cores) and the
# dense TF32 tensor-core rate (the 3xTF32 kernels, lane_mix and
# bank_power, do 3 TF32 passes per product)
HBM_BYTES_PER_S = peaks.HBM_BYTES_PER_S
TF32_FLOPS = 495e12
CONFIGS = Path(__file__).resolve().parent / "benchmark" / "configs"
DEDISPERSE_CU = "baseband_tasks_tpu_torch/csrc/dedisperse.cu"
FOURSTEP_CU = "baseband_tasks_tpu_torch/csrc/fourstep.cu"
PFB_CU = "baseband_tasks_tpu_torch/csrc/pfb.cu"
ACCEL_CU = "baseband_tasks_tpu_torch/csrc/accel.cu"
RESIDENT_CU = "baseband_tasks_tpu_torch/csrc/resident.cu"
HALO_CU = "baseband_tasks_tpu_torch/csrc/halo.cu"
UNPACK_CU = "baseband_tasks_tpu_torch/csrc/unpack.cu"
XCORR_CU = "baseband_tasks_tpu_torch/csrc/xcorr.cu"
KERNELS = {   # launch-count name -> (TPU kernel it replaces, source)
    "k1_packed": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:764",
                  DEDISPERSE_CU),
    "k1_float": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:570",
                 DEDISPERSE_CU),
    "k2": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:259", DEDISPERSE_CU),
    "k3_fold": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:381",
                DEDISPERSE_CU),
    "k1_window": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:223",
                  DEDISPERSE_CU),
    "k2_fwd": ("baseband_tasks_tpu/ops/fft_pallas.py:36", FOURSTEP_CU),
    "k2_inv": ("baseband_tasks_tpu/ops/fft_pallas.py:44", FOURSTEP_CU),
    "k3_trim": ("baseband_tasks_tpu/ops/spectral_filter.py:129",
                FOURSTEP_CU),
    "k1_stream": ("baseband_tasks_tpu/ops/spectral_filter.py:92",
                  DEDISPERSE_CU),
    "lane_mix": ("baseband_tasks_tpu/ops/spectral_filter.py:78",
                 FOURSTEP_CU),
    "pfb_fwd": ("baseband_tasks_tpu/ops/pfb_pallas.py:66", PFB_CU),
    "pfb_fwd_dft": ("baseband_tasks_tpu/ops/pfb_pallas.py:66", PFB_CU),
    "k3_fold_stokes": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:345",
                       DEDISPERSE_CU),
    "k3_power": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:314",
                 FOURSTEP_CU),
    "k2_theta": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:286",
                 DEDISPERSE_CU),
    "k1_planes": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:229",
                  DEDISPERSE_CU),
    "k1_stream_planes": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:240",
                         DEDISPERSE_CU),
    "bank_power": ("baseband_tasks_tpu/ops/accel_correlate.py:134", ACCEL_CU),
    "accel_corr": ("baseband_tasks_tpu/ops/accel_correlate.py:54", ACCEL_CU),
    "resident": ("baseband_tasks_tpu/ops/dedisperse_resident.py:191",
                 RESIDENT_CU),
    # the bf16-intermediate passes (inter_dtype='bfloat16')
    "k1_packed_bf16": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:764",
                       DEDISPERSE_CU),
    "k1_float_bf16": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:570",
                      DEDISPERSE_CU),
    "k2_bf16": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:259",
                DEDISPERSE_CU),
    "k2_bf16_chirp": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:259",
                      DEDISPERSE_CU),
    "k3_fold_bf16": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:381",
                     DEDISPERSE_CU),
    "k3_fold_stokes_bf16": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:345",
                            DEDISPERSE_CU),
    # K3's gather form (many bins), counted beside its launch's name; its
    # entry is K3 Stokes at the GUPPI node's 2048 bins
    "k3_fold_gather": ("baseband_tasks_tpu/ops/dedisperse_pallas.py:345",
                       DEDISPERSE_CU),
    # the halo edges of a time-sharded mesh (halo='remote')
    "halo_remote": ("baseband_tasks_tpu/parallel/halo_pallas.py:73", HALO_CU),
    # GUPPI raw words into K1p's planes (ingest_layout='guppi'), a
    # widening the JAX package lacks
    "guppi_repack": (None, UNPACK_CU),
    # the correlator's X stage with its dump sums (the LOFAR node), which
    # the JAX package computes in plain jnp
    "xcorr": (None, XCORR_CU),
}
FLAGSHIP = ("k1_packed", "k1_float", "k2", "k3_fold")
# the redesigned kernels (K2, resident and K1 on register FFTs, the
# forward PFB's FIR and its DFT on the tensor cores): the time of their
# earlier design at the same shape on this card model, as PERF.md section
# 6 records it (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's
PARENT_MS = {"k2": 0.4884, "k2_bf16": 0.4225, "k2_bf16_chirp": 0.4056,
             "k2_theta": 0.4786, "resident N=2048 power": 1.2330,
             "resident N=2048 stokes": 2.4290,
             "resident N=4096 power": 1.7957,
             "resident N=4096 stokes": 3.2166,
             "k1_packed": 0.2534, "k1_float": 0.3002,
             "k1_packed_bf16": 0.2293, "k1_float_bf16": 0.2626,
             "k1_window": 0.3005, "k1_planes": 0.2998,
             "k1_stream_planes": 0.3028, "k1_stream": 0.1527,
             "pfb_fwd": 0.1763, "pfb_fwd_dft": 1.9871}
# the K1 columns of the paths, (N1, L) by launch: the flagship's window
# (512 x 512, 128 lanes), config 3's stream (128 x 256, 512 lanes) and
# config 2's (512 x 512, 128 lanes); each must run the register kernel
# compiled for its size
K1_PATHS = {"k1_packed": [(512, 128)], "k1_packed_bf16": [(512, 128)],
            "k1_float": [(512, 128)], "k1_float_bf16": [(512, 128)],
            "k1_window": [(512, 128)], "k1_planes": [(512, 128)],
            "k1_stream_planes": [(512, 128)],
            "k1_stream": [(128, 512), (512, 128)]}
VARIANTS = ("k3_fold_stokes", "k3_power", "k2_theta", "k1_planes",
            "k1_stream_planes")
# the GUPPI full-Stokes node's window (n_fft, pad_start, pad_end) and the
# form K3 Stokes takes there at 2048 bins over 128 lanes: 8 lanes' shared
# partials exceed the budget, so it takes the gather form on the 16-lane
# column compiled for it; at 1024 bins the runs form still holds its tile
GUPPI_WINDOW = (1 << 18, 32768, 28672)
GUPPI_K3_FORM = {"tile": 16, "partials": "gather", "form": "register"}
GUPPI_K3_RUNS = {"tile": 8, "partials": "shared", "form": "register"}


def config_pipeline(name):
    """The ``WidebandPulsarPipeline`` keywords of the benchmark's
    configuration ``benchmark/configs/<name>.json``: its geometry, polyco,
    start and ingest."""
    from baseband_tasks_tpu_torch import Polyco, PolycoPhase, Time, units
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    kw = dict(
        n_chan=cfg["n_chan"], n_pol=cfg["n_pol"], dm=cfg["dm"],
        freq_center=cfg["freq_center_mhz"] * units.MHz,
        chan_rate=cfg["chan_rate_khz"] * units.kHz,
        period_samples=tuple(cfg["period_samples"]), n_phase=cfg["n_phase"],
        block_samples=cfg["block_samples"],
        phase_model=PolycoPhase(Polyco("".join(f"{line}\n" for line in
                                               cfg["polyco"]))),
        start_time=Time.from_mjd(float(cfg["start_mjd"])),
        ingest_bits=cfg["ingest_bits"], detect=cfg["detect"])
    if "ingest_layout" in cfg:
        kw["ingest_layout"] = cfg["ingest_layout"]
    return kw


def flagship(device, use_kernels=True, **extra):
    """The flagship pipeline of ``benchmark/configs/flagship_fold.json``
    (kernel path unless told otherwise) on ``device``, or on ``mesh=``
    with ``device`` None; ``extra`` overrides its keywords."""
    from baseband_tasks_tpu_torch import WidebandPulsarPipeline
    return WidebandPulsarPipeline(**{
        **config_pipeline("flagship_fold"), "device": device,
        "use_kernels": use_kernels, **extra})


def guppi_node(device):
    """The GUPPI full-Stokes node of ``benchmark/configs/
    guppi_b1937_stokes.json`` on ``device``: 64 x 1.5625 MHz x 2 pol at
    1150 MHz, DM 71.0197, 2048 Stokes bins, 8-bit GUPPI words."""
    from baseband_tasks_tpu_torch import WidebandPulsarPipeline
    return WidebandPulsarPipeline(
        **config_pipeline("guppi_b1937_stokes"), device=device,
        use_kernels=True)


def guppi_words(dev, n_chan, t, seed):
    """(n_chan, t) int32 GUPPI words of random bytes on ``dev``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n_chan, t, 4), generator=g,
                         dtype=torch.uint8, device=dev).view(
        torch.int32).reshape(n_chan, t)


@functools.lru_cache(maxsize=1)
def flagship_on_host():
    """The flagship configuration (dm, channel frequencies, rate), built
    once on the CPU for its host tables."""
    return flagship("cpu")


def plain(fn):
    """``fn`` run on the plain PyTorch versions of the kernels, through
    the package's test-only switch."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd

    def call(*args, **kwargs):
        with dd.plain_versions():
            return fn(*args, **kwargs)
    return call


def bound(reads, writes, flops, rate=peaks.FP32_FLOPS):
    """(bound_ms, bound_by): the least time of a kernel that reads each
    tensor of ``reads`` once, writes each of ``writes`` once and does
    ``flops`` operations at ``rate`` (FP32 on the CUDA cores unless
    given), at the card's peak rates (``benchmark/peaks.py``)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*reads, *writes))
    seconds, by = peaks.work_bound_s(nbytes, flops * peaks.FP32_FLOPS / rate)
    return 1e3 * seconds, by


def tf32x3_cost(reads, writes, flops):
    """The cost of a 3xTF32 kernel doing the work of ``flops`` FP32
    operations: three TF32 tensor-core passes of it."""
    return reads, writes, 3 * flops, TF32_FLOPS


def both_bounds(cost):
    """'3xTF32 tensor-core bound ... ms, FP32-core bound ... ms' of a
    :func:`tf32x3_cost`."""
    reads, writes, flops, _ = cost
    tc = bound(*cost)[0]
    fp32 = bound(reads, writes, flops // 3)[0]
    return (f"3xTF32 tensor-core bound {tc:.4f} ms, FP32-core bound "
            f"{fp32:.4f} ms")


def full_fp32():
    """Run every float32 matmul of the plain versions and the library
    calls in full float32 (no TF32), and say so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"references: allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"matmul precision {torch.get_float32_matmul_precision()!r}",
          flush=True)


def fft_flops(planes, length, extra=6):
    """FP32 operations of length-``length`` complex FFTs over the points
    of ``planes`` (a re/im pair), plus ``extra`` per point (a twiddle or
    chirp multiply is 6)."""
    return planes[0].numel() * (5 * np.log2(length) + extra)


def result(err, ms, plain_ms, cost, library_ms=None):
    bound_ms, bound_by = bound(*cost)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def parent_note(key, ms):
    """This run's time of a redesigned kernel beside its earlier design's
    recorded one."""
    old = PARENT_MS[key]
    return (f"{key}: {ms:.4f} ms, the earlier design {old:.4f} ms "
            f"(PERF.md section 6): {old / ms:.2f}x")


def check_form(name, y):
    """The register form of K1 launch ``name`` on the paths' columns, or
    of K2 launch ``name`` on planes ``y``."""
    return (check_k1_form(name) if name.startswith("k1")
            else check_k2_form(name, y))


def check_k1_form(name):
    """Each of the paths' columns of K1 launch ``name`` runs the register
    kernel compiled for its size."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    for n1, L in K1_PATHS[name]:
        form = dd.k1_form(n1, L, name)
        if form != "register":
            raise AssertionError(f"{name} at N1={n1}, L={L} runs the {form} "
                                 f"form")
    return "register"


def check_k2_form(name, y):
    """The flagship's stage-B column runs the register K2."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    n2, _, L = y[0].shape
    form = dd.k2_form(name, n2, L)
    if form != "register":
        raise AssertionError(f"{name} at N2={n2}, L={L} runs the {form} form")
    return form


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, ref):
    """Max abs error and its ratio to max |ref| over paired tensors."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    peak = max(float(r.abs().max()) for r in ref)
    return err, err / peak


def flagship_inputs(pipe):
    """One flagship window's kernel inputs on the card: 8-bit packed words
    (the pipeline's own payload) and random float32 planes of the block,
    random edges, the scale, the DM-500 chirp in storage order and the
    polyco's first fold vector."""
    dev = pipe.device
    L = pipe.n_chan * pipe.n_pol
    T = pipe.global_block
    words = [w.reshape(-1, L) for w in
             pipe._payload(7, (T // 4, pipe.n_chan, pipe.n_pol), 8)]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    planes = [torch.randn((T, L), generator=g, device=dev) for _ in (0, 1)]
    edges = [torch.randn((n, L), generator=g, device=dev) for n in
             (pipe.pad_start, pipe.pad_start, pipe.pad_end, pipe.pad_end)]
    scale = torch.tensor([1.0 / 64], device=dev)
    fold = torch.as_tensor(pipe._shard_fold3(pipe.fold_model.table(
        [0], T))[0].astype(np.int32), device=dev)
    return words, planes, edges, scale, pipe._chirp_device(), fold


def check_kernels(pipe, gpu):
    """Phase (a): each kernel against its plain version, then timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    L = pipe.n_chan * pipe.n_pol
    T = pipe.global_block
    words, planes, edges, scale, (csr, csi), fold = flagship_inputs(pipe)
    fold_kw = dict(n_phase=pipe.n_phase, pad_start=pipe.pad_start,
                   n_valid=T)

    cases = {
        "k1_packed": (lambda: dd.stage_a_packed(*words, *edges, scale,
                                                bits=8),
                      lambda: dd.stage_a_packed_ref(*words, *edges, scale,
                                                    bits=8)),
        "k1_float": (lambda: dd.stage_a(*planes, *edges, scale),
                     lambda: dd.stage_a_ref(*planes, *edges, scale)),
    }
    y = dd.stage_a_packed_ref(*words, *edges, scale, bits=8)
    cases["k2"] = (lambda: dd.stage_b(*[p.clone() for p in y], csr, csi),
                   lambda: dd.stage_b_ref(*[p.clone() for p in y], csr,
                                          csi))
    z = dd.stage_b_ref(*[p.clone() for p in y], csr, csi)
    cases["k3_fold"] = (lambda: dd.detect_fold(*z, fold, **fold_kw),
                        lambda: dd.fold_ref(*z, fold, **fold_kw))
    # stage B is timed in place on one scratch copy, without the clones
    # (its chirp has unit modulus, so repeats keep the values bounded)
    work = [p.clone() for p in y]
    timed = dict(cases, k2=(lambda: dd.stage_b(*work, csr, csi),
                            lambda: dd.stage_b_ref(*work, csr, csi)))
    n1 = y[0].shape[1]
    n2 = y[0].shape[0]
    # sizes only: the profile and its counts
    prof_out = torch.empty((pipe.n_phase + 1, L + 1), device="meta")
    costs = {   # (reads, writes, FP32 operations) of each launch
        "k1_packed": ((*words, *edges, scale), y, fft_flops(y, n1)),
        "k1_float": ((*planes, *edges, scale), y, fft_flops(y, n1)),
        "k2": ((*y, csr, csi), y, fft_flops(y, n2, 10 * np.log2(n2) + 12)),
        "k3_fold": ((*z, fold), (prof_out,), fft_flops(z, n1, 5)),
    }

    results = {}
    for name, (kern, plain_fn) in cases.items():
        got, ref = kern(), plain_fn()
        torch.cuda.synchronize()
        if name == "k3_fold":
            if not torch.equal(got[1], ref[1]):
                raise AssertionError(f"{name}: counts differ")
            err = float((got[0] - ref[0]).abs().max())
            rel = float(((got[0] - ref[0]).abs()
                         / ref[0].abs().clamp_min(1e-30)).max())
            ok = rel <= PROFILE_RTOL
        else:
            err, rel = compare(got, ref)
            ok = rel <= FFT_TOL
        print(f"(a) {name}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"({'ok' if ok else 'FAIL'})", flush=True)
        if not ok or not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{name} disagrees with its plain version")
        ms, plain_ms = (cuda_ms(f) for f in timed[name])
        results[name] = result(err, ms, plain_ms, costs[name])
        print(f"(a) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}) [{gpu}]", flush=True)
        if name == "k2":
            print(f"(a) {parent_note(name, ms)}, {check_k2_form(name, y)} "
                  f"form [{gpu}]", flush=True)
        elif name.startswith("k1"):
            print(f"(a) {parent_note(name, ms)}, {check_form(name, y)} "
                  f"form [{gpu}]", flush=True)
    return results


def drive_main_path(kern):
    """Phase (b): the pipeline's entry points with the kernels, counted,
    then held against the plain versions on the card."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dd.reset_launch_counts()
    runs = {"packed": kern.run_fn(N_ITER, ingest_bits=8)(seed=0),
            "float32": kern.run_fn(2)(seed=0)}
    torch.cuda.synchronize()
    launches = dict(dd.launch_counts)
    print(f"(b) launches: {launches}", flush=True)
    missing = [k for k in FLAGSHIP if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    refs = {"packed": plain(kern.run_fn(N_ITER, ingest_bits=8))(seed=0),
            "float32": plain(kern.run_fn(2))(seed=0)}
    for key, n in (("packed", N_ITER), ("float32", 2)):
        (prof, cnt), (rprof, rcnt) = runs[key], refs[key]
        want = n * kern.global_block
        total = int(cnt.sum())
        shape = (kern.n_phase, kern.n_chan, kern.n_pol)
        print(f"(b) {key}: counts sum {total} (want {want}), profile "
              f"{tuple(prof.shape)}", flush=True)
        if total != want or not torch.equal(cnt, rcnt):
            raise AssertionError(f"{key}: counts wrong")
        if tuple(prof.shape) != shape or not torch.isfinite(prof).all():
            raise AssertionError(f"{key}: profile not finite/shaped")
        rel = float(((prof - rprof).abs() / rprof.abs()).max())
        print(f"(b) {key}: profile max rel err vs plain {rel:.3e}",
              flush=True)
        if rel > PROFILE_RTOL:
            raise AssertionError(f"{key}: profile disagrees with plain")
    return launches


def time_steps(kern, gpu):
    """Phase (c): one flagship step, kernels vs plain, in turns."""
    runs = {"kernels": kern.run_fn(N_ITER, ingest_bits=8),
            "plain": plain(kern.run_fn(N_ITER, ingest_bits=8))}
    best = {}
    for key in ("plain", "kernels", "kernels", "plain"):
        runs[key](seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[key](seed=0)
        torch.cuda.synchronize()
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    samples = N_ITER * kern.block_samples * kern.n_chan * kern.n_pol
    for key, dt in best.items():
        print(f"(c) step {key}: {1e3 * dt / N_ITER:.3f} ms/step, "
              f"{samples / dt:.4e} samples/s [{gpu}]", flush=True)


def config2_source(dev, n_samples=1 << 23):
    """``tools/bench_full.py`` config 2's source, on the card: 128 x
    125 kHz complex channels around 1400 MHz, sideband +1, 2^23 samples
    (or ``n_samples``: the same samples, fewer of them) of noise from
    seed 1 in frames of 8192."""
    from baseband_tasks_tpu_torch import (NoiseGenerator, SetAttribute,
                                          Time, units as u)
    n_chan = 128
    freq = (1400 + (np.arange(n_chan) - n_chan / 2) * 0.125) * u.MHz
    return SetAttribute(NoiseGenerator(
        shape=(n_samples, n_chan), start_time=Time.from_mjd(58000.0),
        sample_rate=125 * u.kHz, samples_per_frame=8192, seed=1,
        device=dev), frequency=freq, sideband=1)


def check_four_step(dev, gpu):
    """Phase (d): the four-step kernels against their plain versions at
    N = 2^18, L = 128, then timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd, fft as ff
    n, L = 1 << 18, 128
    n1, n2 = dd.split_n(n)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    x = [torch.randn((n, L), generator=g, device=dev) for _ in (0, 1)]
    y = [torch.randn((n2, n1, L), generator=g, device=dev) for _ in (0, 1)]
    pads = dict(pad_start=512, pad_end=512)
    cases = {"k1_window": [(lambda: ff.k1_window(*x),
                            lambda: ff.k1_window_ref(*x))],
             "k3_trim": [(lambda: ff.k3_trim(*y, **pads),
                          lambda: ff.k3_trim_ref(*y, **pads))],
             "k2_fwd": [], "k2_inv": []}
    for ortho in (False, True):
        fwd = ff.fft_scale(n, inverse=False, ortho=ortho)
        inv = ff.fft_scale(n, inverse=True, ortho=ortho) * n1
        cases["k2_fwd"].append((lambda s=fwd: ff.k2_fwd(*y, s),
                                lambda s=fwd: ff.k2_fwd_ref(*y, s)))
        cases["k2_inv"].append((lambda s=inv: ff.k2_inv(*y, s),
                                lambda s=inv: ff.k2_inv_ref(*y, s)))
    trimmed = [torch.empty((n - 1024, L), device="meta") for _ in (0, 1)]
    costs = {"k1_window": (x, y, fft_flops(y, n1)),
             "k3_trim": (y, trimmed, fft_flops(y, n1, 0)),
             "k2_fwd": (y, y, fft_flops(y, n2, 1)),
             "k2_inv": (y, y, fft_flops(y, n2, 7))}
    results = {}
    for name, pairs in cases.items():
        errs = []
        for kern, plain_fn in pairs:
            got, ref = kern(), plain_fn()
            torch.cuda.synchronize()
            err, rel = compare(got, ref)
            ok = rel <= FFT_TOL and all(bool(torch.isfinite(t).all())
                                        for t in got)
            print(f"(d) {name}: max_abs_err={err:.3e} rel={rel:.3e} "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version")
            errs.append(err)
        ms, plain_ms = (cuda_ms(f) for f in pairs[0])
        results[name] = result(max(errs), ms, plain_ms, costs[name])
        print(f"(d) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {results[name]['bound_ms']:.4f} ms [{gpu}]", flush=True)
        if name in PARENT_MS:
            print(f"(d) {parent_note(name, ms)}, {check_k1_form(name)} form "
                  f"[{gpu}]", flush=True)
    # the one library call computing the whole transform (k1_window then
    # k2_fwd): cuFFT through torch.fft, on the same data as complex64
    xc = torch.complex(*x)
    fft_ms = cuda_ms(lambda: torch.fft.fft(xc, dim=0))
    passes = results["k1_window"]["ms"] + results["k2_fwd"]["ms"]
    print(f"(d) torch.fft.fft over time, {n} x {L} complex64: {fft_ms:.4f} "
          f"ms; k1_window + k2_fwd {passes:.4f} ms [{gpu}]", flush=True)
    return results


def task_paths(src):
    """The two config-2 stream-task paths: (name, stream, FFT engine to
    read it under)."""
    from baseband_tasks_tpu_torch import Dechannelize, Dedisperse
    from baseband_tasks_tpu_torch.fourier import PallasFFTMaker, fft_maker
    ded = Dedisperse(src, 29.7, samples_per_frame=2 ** 17, engine="pallas")
    engine = PallasFFTMaker()
    with fft_maker.set(engine):
        xla = Dedisperse(src, 29.7, samples_per_frame=2 ** 18 - 693,
                         engine="xla")
    return [("dedisperse_dechannelize", Dechannelize(ded), None),
            ("xla_under_pallas_fft", xla, engine)]


def read_frames(stream, engine, first, count):
    """Frames [first, first + count) of ``stream``, read under FFT
    ``engine`` (None: the default), synchronized."""
    from baseband_tasks_tpu_torch.fourier import fft_maker
    spf = stream.samples_per_frame
    with (fft_maker.set(engine) if engine else contextlib.nullcontext()):
        stream.seek(first * spf)
        out = stream.read(count * spf)
    torch.cuda.synchronize()
    return out


def check_geometry(name, stream, engine):
    """The full-width geometry of each path, and that it runs the
    four-step kernels."""
    n_chan = 128
    if name == "dedisperse_dechannelize":
        ded = stream.ih
        want = (512, 512, 1 << 18, 261120)
        ok = (ded.engine == "pallas" and stream.sample_shape == ()
              and stream.samples_per_frame == 261120 * n_chan)
    else:
        ded = stream
        want = (346, 347, 1 << 18, 2 ** 18 - 693)
        ok = (ded.engine == "xla" and stream.sample_shape == (n_chan,)
              and engine((1 << 18, n_chan), np.complex64)._use_pallas)
    got = (ded.pad_start, ded.pad_end, ded._padded_samples_per_frame,
           ded.samples_per_frame)
    print(f"(e) {name}: pads {got[:2]}, window {got[2]}, "
          f"{got[3]} valid samples per channel per frame, output "
          f"{stream.shape}, {stream.samples_per_frame} samples per frame",
          flush=True)
    if got != want or not ok:
        raise AssertionError(f"{name}: geometry {got}, want {want}")


def drive_task_paths(dev, gpu):
    """Phase (e): both config-2 stream-task paths at full width with the
    kernels, counted, then held against the same paths read on the plain
    versions on the card."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    src = config2_source(dev)
    kern, ref_paths = task_paths(src), task_paths(src)
    needs = {"dedisperse_dechannelize": ("k1_window", "k2", "k3_trim"),
             "xla_under_pallas_fft": ("k1_window", "k2_fwd", "k2_inv",
                                      "k3_trim")}
    launches = {}
    for (name, stream, engine), (_, ref_stream, ref_engine) in zip(
            kern, ref_paths):
        check_geometry(name, stream, engine)
        dd.reset_launch_counts()
        got = read_frames(stream, engine, 0, N_FRAMES)
        counts = dict(dd.launch_counts)
        print(f"(e) {name}: launches {counts}", flush=True)
        missing = [k for k in needs[name] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        ref = plain(read_frames)(ref_stream, ref_engine, 0, N_FRAMES)
        want = (N_FRAMES * stream.samples_per_frame,) + stream.sample_shape
        err, rel = compare((got.real, got.imag), (ref.real, ref.imag))
        print(f"(e) {name}: {tuple(got.shape)} {got.dtype}, max abs err "
              f"vs plain {err:.3e}, {rel:.3e} of the peak [{gpu}]",
              flush=True)
        if tuple(got.shape) != want or not torch.isfinite(
                torch.view_as_real(got)).all() or rel > FFT_TOL:
            raise AssertionError(f"{name}: output wrong")
        del got, ref
    return launches, kern[0], ref_paths[0]


def time_task_frame(kern, ref, gpu):
    """Phase (f): one frame of Dechannelize(Dedisperse(engine='pallas')),
    kernels against plain versions, in turns (plain, kernels, kernels,
    plain), each turn reading a frame not read before."""
    runs = {"kernels": (kern, read_frames), "plain": (ref, plain(read_frames))}
    best = {}
    for frame, key in enumerate(("plain", "kernels", "kernels", "plain"),
                                start=N_FRAMES):
        (_, stream, engine), read = runs[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        read(stream, engine, frame, 1)
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    samples = kern[1].samples_per_frame
    for key, dt in best.items():
        print(f"(f) dedisperse+dechannelize frame {key}: {1e3 * dt:.3f} "
              f"ms/frame, {samples / dt:.4e} samples/s [{gpu}]", flush=True)
    layer_times(kern, N_FRAMES + 4, gpu)
    profile_frame(kern, N_FRAMES + 5, gpu)
    return best


def layer_times(kern, frame, gpu):
    """A kernels frame by layer, host clock around synchronized calls
    (best of two): the source read of the padded window, the
    dedispersion task on it, the Dechannelize task on its output."""
    _, dch, _ = kern
    ded = dch.ih
    src = ded.ih
    start, stop = ded._seek_frame(frame)

    def timed(fn):
        best = np.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, 1e3 * best

    def read_window():
        src.seek(start)
        return src.read(stop - start)
    window, t_src = timed(read_window)
    filtered, t_ded = timed(lambda: ded.task(window))
    _, t_dch = timed(lambda: dch.task(filtered))
    print(f"(f) frame by layer: source read {t_src:.3f} ms, dedisperse "
          f"task {t_ded:.3f} ms, dechannelize task {t_dch:.3f} ms [{gpu}]",
          flush=True)


def device_profile(fn):
    """One call of ``fn`` under ``torch.profiler`` (which stretches it):
    (wall ms to the device's end, device-busy ms, [(device us, count,
    kernel name)] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return 1e3 * wall, sum(r[0] for r in rows) / 1e3, sorted(rows,
                                                             reverse=True)


def profile_frame(kern, frame, gpu):
    """Where a kernels frame's time goes: device time by kernel under
    ``torch.profiler``, and the busy share."""
    _, stream, engine = kern
    wall, busy, rows = device_profile(
        lambda: read_frames(stream, engine, frame, 1))
    print(f"(f) profiled frame: {wall:.3f} ms wall, {busy:.3f} ms "
          f"device busy ({busy / wall:.2f}) [{gpu}]", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"(f)   {dev_us / 1e3:8.3f} ms  x{count:<3d} {key[:90]}",
              flush=True)


# -- the compiled slice: phases (g) and (h) --------------------------------

def randn(dev, shape, seed, count=2):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev) for _ in range(count)]


def check_compiled_kernels(dev, gpu):
    """Phase (g): the compiled slice's kernels against their plain
    versions at the shapes of the config-3 and config-2 paths, timed."""
    from baseband_tasks_tpu_torch import sinc_hamming
    from baseband_tasks_tpu_torch.ops import fft as ff, pfb as opfb
    from baseband_tasks_tpu_torch.ops import spectral_filter as sf
    from baseband_tasks_tpu_torch.ops.dedisperse import split_n
    from baseband_tasks_tpu_torch.ops.dft_matmul import (_expanded_mats,
                                                         device_mats)
    m, L, n_tap = 32256, 512, 8
    taps = torch.as_tensor(np.repeat(sinc_hamming(n_tap, 256), 2, axis=1),
                           device=dev)
    fwd = device_mats(_expanded_mats(256, 2, "forward"), dev)
    pre = device_mats(sf.expand_lane_mats(sf.lane_dft_mats(256), 2), dev)
    post = device_mats(sf.lane_dft_mats(128), dev)
    carry, x = randn(dev, (n_tap - 1, L), 40), randn(dev, (m, L), 41)
    scale = torch.tensor([0.75], device=dev)
    pfb_kw = dict(n_tap=n_tap, scale=scale)
    n, pad = 1 << 15, 512                 # the config-3 spectra window
    sc, sx = randn(dev, (pad, L), 42), randn(dev, (n - pad, L), 43)

    def with_pre(stage_a, mix):
        def run():
            y = stage_a(*sc, *sx, scale)
            return mix(*(p.reshape(n, L) for p in y), *pre)
        return run
    n2c, n1c = 512, 512                   # the config-2 window, 2^18
    z = randn(dev, (n2c, n1c, 128), 44)
    trim = dict(pad_start=512, pad_end=512)
    rows = randn(dev, (n, L), 45)
    cases = {
        "pfb_fwd": (lambda: opfb.pfb_forward_stream(*carry, *x, taps,
                                                    **pfb_kw),
                    lambda: opfb.pfb_forward_stream_ref(*carry, *x, taps,
                                                        **pfb_kw)),
        "pfb_fwd_dft": (lambda: opfb.pfb_forward_stream(*carry, *x, taps,
                                                        *fwd, **pfb_kw),
                        lambda: opfb.pfb_forward_stream_ref(*carry, *x, taps,
                                                            *fwd, **pfb_kw)),
        "k1_stream": (lambda: ff.k1_stream(*sc, *sx, scale),
                      lambda: ff.k1_stream_ref(*sc, *sx, scale)),
        "k1_stream+pre": (with_pre(ff.k1_stream, sf.lane_mix),
                          with_pre(ff.k1_stream_ref, sf.lane_mix_ref)),
        "lane_mix": (lambda: sf.lane_mix(*rows, *pre),
                     lambda: sf.lane_mix_ref(*rows, *pre)),
        "k3_trim+post": (lambda: sf.lane_mix(*ff.k3_trim(*z, **trim), *post),
                         lambda: sf.lane_mix_ref(*ff.k3_trim_ref(*z, **trim),
                                                 *post)),
    }
    out = [torch.empty((m, L), device="meta") for _ in (0, 1)]
    spectra = [torch.empty((n, L), device="meta") for _ in (0, 1)]
    tap_flops = 4 * m * L * n_tap
    mix_flops = 8 * L                    # per output element
    costs = {
        "pfb_fwd": ((*carry, *x, taps), out, tap_flops),
        # the DFT's product in 3xTF32 on the tensor cores (the tap sums'
        # FP32 work, 1/64 of it, overlaps)
        "pfb_fwd_dft": tf32x3_cost((*carry, *x, taps, *fwd), out,
                                   m * L * mix_flops),
        "k1_stream": ((*sc, *sx, scale), spectra,
                      fft_flops(spectra, split_n(n)[0])),
        "lane_mix": tf32x3_cost((*rows, *pre), rows, n * L * mix_flops),
    }
    wc = torch.complex(*pre)
    rc = torch.complex(*rows)
    # the DFT product of the tap sums alone: one cgemm
    ac = torch.complex(*opfb.pfb_forward_stream_ref(*carry, *x, taps,
                                                    **pfb_kw))
    fc = torch.complex(*fwd)
    library = {"lane_mix": lambda: torch.matmul(rc, wc),   # one cgemm
               "pfb_fwd_dft": lambda: torch.matmul(ac, fc)}
    results = {}
    full_fp32()
    for name, (kern, plain_fn) in cases.items():
        got, ref = kern(), plain_fn()
        torch.cuda.synchronize()
        err, rel = compare(got, ref)
        ok = rel <= FFT_TOL and all(bool(torch.isfinite(t).all())
                                    for t in got)
        print(f"(g) {name}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"({'ok' if ok else 'FAIL'})", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        del got, ref
        ms, plain_ms = (cuda_ms(f, reps=10) for f in (kern, plain_fn))
        print(f"(g) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain "
              f"[{gpu}]", flush=True)
        if "+" not in name:
            lib_ms = (cuda_ms(library[name], reps=10) if name in library
                      else None)
            results[name] = result(err, ms, plain_ms, costs[name], lib_ms)
            print(f"(g) {name}: bound {results[name]['bound_ms']:.4f} ms "
                  f"({results[name]['bound_by']}), library "
                  f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
                  f"[{gpu}]", flush=True)
            if name in PARENT_MS:
                print(f"(g) {parent_note(name, ms)}"
                      + (f", {check_k1_form(name)} form" if name == "k1_stream"
                         else "") + f" [{gpu}]", flush=True)
            if name == "lane_mix":
                print(f"(g) lane_mix 2^15 x 512: {both_bounds(costs[name])}",
                      flush=True)
            if name == "pfb_fwd_dft":
                # the yardstick the fused kernel must beat: the FIR, then
                # lane_mix on its output (a measurement only)
                pair_ms = cuda_ms(lambda: sf.lane_mix(*opfb.pfb_forward_stream(
                    *carry, *x, taps, **pfb_kw), *fwd), reps=10)
                print(f"(g) pfb_fwd_dft 32256 x 512: {ms:.4f} ms fused, "
                      f"{pair_ms:.4f} ms pfb_fwd then lane_mix, {lib_ms:.4f} "
                      f"ms library (one complex matmul of the tap sums by "
                      f"F), {both_bounds(costs[name])} [{gpu}]", flush=True)
    del rows, rc, wc, ac, fc
    # 3xTF32 against the float64 product by depth 2L: float32-class at
    # every depth (the kernel promotes its partial sums; one TF32 pass is
    # ~3e-4 of the peak)
    for L_mix in (128, 512, 1600):
        x, w = randn(dev, (4096, L_mix), 47), randn(dev, (L_mix, L_mix), 48)
        got = sf.lane_mix(*x, *w)
        ref = sf.lane_mix_ref(*(t.double() for t in (*x, *w)))
        rel = compare(got, ref)[1]
        print(f"(g) lane_mix 4096 x {L_mix} against float64: rel {rel:.3e} "
              f"(limit {TF32X3_TOL:g})", flush=True)
        if not rel <= TF32X3_TOL:
            raise AssertionError(f"lane_mix at L = {L_mix} is not "
                                 f"float32-class against float64")
        del x, w, got, ref
    post_rows = randn(dev, (261120, 128), 46)
    got = sf.lane_mix(*post_rows, *post)
    err, rel = compare(got, sf.lane_mix_ref(*post_rows, *post))
    ok = rel <= FFT_TOL and all(bool(torch.isfinite(t).all()) for t in got)
    print(f"(g) lane_mix at the config-2 post shape 261120 x 128: "
          f"max_abs_err={err:.3e} rel={rel:.3e} ({'ok' if ok else 'FAIL'})",
          flush=True)
    if not ok:
        raise AssertionError("lane_mix disagrees with its plain version at "
                             "the config-2 post shape")
    del got
    pc = torch.complex(*post_rows)
    wc = torch.complex(*post)
    ms, plain_ms, lib_ms = (cuda_ms(f, reps=10) for f in (
        lambda: sf.lane_mix(*post_rows, *post),
        lambda: sf.lane_mix_ref(*post_rows, *post),
        lambda: torch.matmul(pc, wc)))
    cost = tf32x3_cost((*post_rows, *post), post_rows,
                       post_rows[0].numel() * 8 * 128)
    print(f"(g) lane_mix at the config-2 post shape 261120 x 128: "
          f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms "
          f"library (one complex matmul), {both_bounds(cost)} [{gpu}]",
          flush=True)
    return results


def compiled_tail(name, dev, offset=0, n_samples=None):
    """The tail of compiled path ``name`` on the card, with ``offset``
    samples sliced off its source (``n_samples`` long: config 2's 2^23
    and config 3's 2^24 by default).

    config3_quad, pfb_forward, dechan_inverse: ``tools/bench_full.py``
    config 3 (8 taps x 256 channels, frames of 32256 spectra, inverse
    pads 128/128 spectra, sn 30): the round trip, the forward PFB alone,
    and Dechannelize -> inverse PFB on a stream of spectra.  config2:
    Dechannelize(Dedisperse(engine='pallas')) on config 2's source.
    """
    from baseband_tasks_tpu_torch import (
        Dechannelize, Dedisperse, InversePolyphaseFilterBank, NoiseGenerator,
        PolyphaseFilterBank, Time, sinc_hamming, units as u)

    def sliced(src):
        return src[offset:] if offset else src
    if name == "config2":
        src = config2_source(dev, n_samples or 1 << 23)
        return Dechannelize(Dedisperse(sliced(src), 29.7,
                                       samples_per_frame=2 ** 17,
                                       engine="pallas"))
    h = sinc_hamming(8, 256)
    inv_kw = dict(sn=30, pad_start=128, pad_end=128, samples_per_frame=32256,
                  engine="pallas")
    t0 = Time.from_mjd(58000.0)
    if name == "dechan_inverse":
        spectra = NoiseGenerator(shape=(1 << 17, 256, 2), start_time=t0,
                                 sample_rate=4 * u.MHz / 256,
                                 samples_per_frame=1 << 12, seed=3,
                                 device=dev)
        return InversePolyphaseFilterBank(sliced(spectra), h, **inv_kw)
    src = NoiseGenerator(shape=(n_samples or 1 << 24, 2), start_time=t0,
                         sample_rate=4 * u.MHz, samples_per_frame=1 << 16,
                         seed=2, device=dev)
    pfb = PolyphaseFilterBank(sliced(src), h, samples_per_frame=32256)
    if name == "pfb_forward":
        return pfb
    return InversePolyphaseFilterBank(pfb, h, dtype=src.dtype, **inv_kw)


# name -> (fused stage classes, kernels its main path launches, kernels it
# must not launch)
COMPILED = {
    "config3_quad": (["_FusedPolyphaseFIR", "_FusedDechanInvPFB"],
                     ("pfb_fwd", "k1_stream", "k2", "k3_trim"),
                     ("lane_mix", "pfb_fwd_dft")),
    "config2": (["_FusedDisperseDechan"],
                ("k1_stream", "k2", "k3_trim", "lane_mix"), ("k1_window",)),
    "pfb_forward": (["_FusedPFBForward"], ("pfb_fwd_dft",), ("pfb_fwd",)),
    "dechan_inverse": (["_FusedDechanInvPFB"],
                       ("k1_stream", "lane_mix", "k2", "k3_trim"),
                       ("k1_window",)),
}


def check_compiled_geometry(name, cp):
    fused = [st.fused for st in cp.stages if st.fused is not None]
    names = [type(f).__name__ for f in fused]
    tail = cp._tail
    print(f"(h) {name}: fused {names}, block {cp.block_samples} source "
          f"samples -> {cp.tail_block}, delay {cp.delay}, warmup "
          f"{cp.warmup}", flush=True)
    if names != COMPILED[name][0]:
        raise AssertionError(f"{name}: fused {names}")
    if name in ("config3_quad", "dechan_inverse"):
        rows = tail._padded_samples_per_frame // 256
        pads = (tail.pad_start // 256, tail.pad_end // 256)
        lanes = 256 * 2
        print(f"(h) {name}: engine {tail.engine}, window {rows} rows, pads "
              f"{pads} rows, L {lanes}", flush=True)
        want_pre = name == "dechan_inverse"
        if (tail.engine != "pallas" or rows != 1 << 15 or pads != (256, 256)
                or (fused[-1].pre is not None) != want_pre):
            raise AssertionError(f"{name}: geometry or engine wrong")
    if name == "pfb_forward" and (fused[0].L != 512 or not fused[0].with_dft):
        raise AssertionError("pfb_forward: not the 512-lane DFT fusion")


def run_planes(cp, blocks, scales):
    """The compiled planes step over ``blocks`` from zeroed carries."""
    step, carry = cp.planes_step(), cp.init_carry(planes=True)
    outs = []
    for x, s in zip(blocks, scales):
        carry, y = step(carry, x, s)
        outs.append(y)
    torch.cuda.synchronize()
    return outs


def joined(outs):
    return torch.complex(torch.cat([y[0] for y in outs]),
                         torch.cat([y[1] for y in outs]))


def eager_bound(name, what, got, eager, gpu, phase="(h)"):
    """Max |got - eager| over the rtol/atol bound, printed with the SNR."""
    diff = (got - eager).abs()
    ratio = float((diff / (EAGER_ATOL + EAGER_RTOL * eager.abs())).max())
    power = (eager.abs() ** 2).mean()
    snr = float(10 * torch.log10(power / (diff ** 2).mean().clamp_min(
        1e-30)))
    print(f"{phase} {name}: vs eager {what} ({got.shape[0]} samples): "
          f"max |d| {float(diff.max()):.3e}, rms |eager| "
          f"{float(power.sqrt()):.3e}, SNR {snr:.1f} dB, {ratio:.3f} of the "
          f"rtol/atol bound [{gpu}]", flush=True)
    return ratio


def check_against_eager(name, cp, got, dev, gpu):
    """Compiled sample k >= warmup against the port's eager sample
    k - delay, two ways.

    As built: the eager chain's frames start at the stream start, so its
    windows sit off the compiled ones (a frame does not divide the pads)
    and the two agree to the overlap-save leakage: held to rtol 1e-3,
    atol 2e-3 for the paths of EAGER_AS_BUILT, reported for config 2.  On
    the compiled windows: the same eager chain on the source with one
    block less the delay sliced off, whose frame 0 is the compiled window
    of block 1 and whose sample i is eager sample k - delay for compiled
    k = tail_block + i: held to rtol 1e-3, atol 2e-3.
    """
    delay, w, tb = int(cp.delay), cp.warmup, cp.tail_block
    tail = cp._tail
    tail.seek(0)
    eager = tail.read(got.shape[0] - delay)
    torch.cuda.synchronize()
    if eager_bound(name, "as built, past warmup", got[w:], eager[w - delay:],
                   gpu) > 1.0 and name in EAGER_AS_BUILT:
        raise AssertionError(f"{name}: compiled disagrees with eager as "
                             f"built")
    del eager
    offset = cp.block_samples - delay * cp.block_samples // tb
    aligned = compiled_tail(name, dev, offset).read(tb)
    torch.cuda.synchronize()
    if eager_bound(name, "on the compiled windows (block 1)",
                   got[tb:2 * tb], aligned, gpu) > 1.0:
        raise AssertionError(f"{name}: compiled disagrees with eager")


def drive_compiled(name, dev, gpu, n_blocks=2):
    """One compiled path: geometry, counted kernel run, the same pipeline
    built again and run on the plain versions, the comparisons.  Returns
    the kernels' launch counts and the two pipelines."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    kern, ref_cp = (CompiledPipeline(compiled_tail(name, dev))
                    for _ in range(2))
    check_compiled_geometry(name, kern)
    blocks = kern.read_source_blocks(n_blocks)
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    outs = run_planes(kern, blocks, [None] * n_blocks)
    counts = dict(dd.launch_counts)
    print(f"(h) {name}: launches {counts}", flush=True)
    _, needs, forbidden = COMPILED[name]
    missing = [k for k in needs if counts[k] <= 0]
    stray = [k for k in forbidden if counts[k]]
    if missing or stray:
        raise AssertionError(f"{name}: not launched {missing}, launched "
                             f"{stray}")
    dd.reset_launch_counts()
    refs = plain(run_planes)(ref_cp, blocks, [None] * n_blocks)
    if any(dd.launch_counts.values()):
        raise AssertionError(f"{name}: the plain pipeline launched kernels")
    got, ref = joined(outs), joined(refs)
    err, rel = compare((got.real, got.imag), (ref.real, ref.imag))
    want = (n_blocks * kern.tail_block,) + tuple(kern._tail.sample_shape)
    print(f"(h) {name}: {tuple(got.shape)}, kernels vs plain max abs err "
          f"{err:.3e}, {rel:.3e} of the peak [{gpu}]", flush=True)
    if tuple(got.shape) != want or rel > FFT_TOL or not torch.isfinite(
            torch.view_as_real(got)).all():
        raise AssertionError(f"{name}: output wrong")
    del outs, refs, ref
    scales = [0.5, 2.0][:n_blocks]
    a = joined(run_planes(kern, blocks, scales))
    b = joined(plain(run_planes)(ref_cp, blocks, scales))
    err, rel = compare((a.real, a.imag), (b.real, b.imag))
    del a, b
    print(f"(h) {name}: with per-block scales {scales}: {rel:.3e} of the "
          f"peak", flush=True)
    if rel > FFT_TOL:
        raise AssertionError(f"{name}: scaled output wrong")
    check_against_eager(name, kern, got, dev, gpu)
    del got, blocks
    return counts, kern, ref_cp


def time_compiled(name, kern, ref_cp, gpu, eager_ms=None, phase="(h)"):
    """ms per block of the compiled planes step over one block already on
    the card, N_STEPS chained steps a turn, turns plain, kernels,
    kernels, plain; then one profiled turn of the kernels."""
    block = kern.read_source_blocks(1)[0]
    x = (block.real.contiguous(), block.imag.contiguous())
    steps = {"kernels": kern.planes_step(),
             "plain": plain(ref_cp.planes_step())}
    cps = {"kernels": kern, "plain": ref_cp}

    def turn(key):
        carry = cps[key].init_carry(planes=True)
        for i in range(N_STEPS):
            carry, _ = steps[key](carry, x, 1.0 + 1e-6 * i)
    best = {}
    for key in ("plain", "kernels", "kernels", "plain"):
        turn(key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turn(key)
        torch.cuda.synchronize()
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    samples = kern.tail_block * int(np.prod(kern._tail.sample_shape or (1,)))
    for key, dt in best.items():
        print(f"{phase} {name} compiled {key}: "
              f"{1e3 * dt / N_STEPS:.3f} ms/block, "
              f"{samples * N_STEPS / dt:.4e} output samples/s [{gpu}]",
              flush=True)
    if eager_ms is not None:
        print(f"{phase} {name}: eager kernels frame (phase (f)) "
              f"{eager_ms:.3f} ms for the same {kern.tail_block} samples, "
              f"source included [{gpu}]", flush=True)
    wall, busy, rows = device_profile(lambda: turn("kernels"))
    print(f"{phase} {name} profiled turn: {wall / N_STEPS:.3f} ms/block "
          f"wall, {busy / N_STEPS:.3f} ms/block device busy "
          f"({busy / wall:.2f}) [{gpu}]", flush=True)
    for dev_us, count, key in rows[:8]:
        print(f"{phase}   {dev_us / 1e3 / N_STEPS:8.3f} ms/block  "
              f"x{count:<3d} {key[:80]}", flush=True)


def drive_compiled_paths(dev, gpu, eager_c2_ms):
    """Phase (h): the four compiled paths, then config 3, the forward PFB,
    config 2 and Dechannelize -> inverse PFB timed.  Returns the launch counts summed
    over the counted runs."""
    launches, timed = {}, {}
    full_fp32()
    for name in ("config3_quad", "pfb_forward", "dechan_inverse",
                 "config2"):
        counts, kcp, pcp = drive_compiled(name, dev, gpu)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        timed[name] = (kcp, pcp)
        torch.cuda.empty_cache()
    time_compiled("config3_quad", *timed["config3_quad"], gpu)
    time_compiled("pfb_forward", *timed["pfb_forward"], gpu)
    time_compiled("config2", *timed["config2"], gpu, eager_ms=eager_c2_ms)
    time_compiled("dechan_inverse", *timed["dechan_inverse"], gpu)
    return launches


# -- the flagship's variants: phases (i) and (j) ----------------------------

def check_variant_kernels(pipe, gpu):
    """Phase (i): the variants' launches against their plain versions at
    the shapes the flagship paths give them, timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dev = pipe.device
    L = pipe.n_chan * pipe.n_pol
    T, N = pipe.global_block, pipe._n_fft
    n1, n2 = dd.split_n(N)
    (x2w,) = randn(dev, (2, N, L), 50, count=1)        # a padded window
    (x2,) = randn(dev, (2, T, L), 51, count=1)         # block + edges
    front, end = (randn(dev, (2, p, L), 52 + p, count=1)[0]
                  for p in (pipe.pad_start, pipe.pad_end))
    scale = torch.tensor([1.0 + 1e-6 * 300], device=dev)
    csr, csi = pipe._chirp_device()
    theta = pipe._theta_device()
    y = dd.stage_a_window_ref(torch.complex(x2w[0], x2w[1]))
    z = dd.stage_b_ref(*[p.clone() for p in y], csr, csi)
    fold = torch.as_tensor(pipe._shard_fold3(pipe.fold_model.table(
        [0], T))[0].astype(np.int32), device=dev)
    kw = dict(n_phase=pipe.n_phase, pad_start=pipe.pad_start, n_valid=T,
              stokes=True)
    cases = {
        "k3_fold_stokes": (lambda: dd.detect_fold(*z, fold, **kw),
                           lambda: dd.fold_ref(*z, fold, **kw)),
        "k3_power": (lambda: dd.k3_power(*z), lambda: dd.k3_power_ref(*z)),
        "k2_theta": (lambda: dd.stage_b_theta(*[p.clone() for p in y], theta),
                     lambda: dd.k2_theta_ref(*[p.clone() for p in y], theta)),
        "k1_planes": (lambda: dd.stage_a_planes(x2w),
                      lambda: dd.stage_a_window_ref(torch.complex(x2w[0],
                                                                  x2w[1]))),
        "k1_stream_planes": (
            lambda: dd.stage_a_stream_planes(x2, front, end, scale),
            lambda: dd.stage_a_ref(x2[0], x2[1], front[0], front[1], end[0],
                                   end[1], scale)),
    }
    # stage B timed in place on one scratch copy (unit-modulus chirp)
    work = [p.clone() for p in y]
    timed = dict(cases, k2_theta=(lambda: dd.stage_b_theta(*work, theta),
                                  lambda: dd.k2_theta_ref(*work, theta)))
    meta = dict(device="meta")
    costs = {
        "k3_fold_stokes": ((*z, fold),
                           (torch.empty((pipe.n_phase + 1, 3 * L + 1),
                                        **meta),),
                           fft_flops(z, n1, 11)),
        "k3_power": (z, (torch.empty((N, L), **meta),), fft_flops(z, n1, 3)),
        "k2_theta": ((*y, theta), y,
                     fft_flops(y, n2, 10 * np.log2(n2) + 12)),
        "k1_planes": ((x2w,), y, fft_flops(y, n1)),
        "k1_stream_planes": ((x2, front, end, scale), y, fft_flops(y, n1)),
    }
    results = {}
    for name, (kern, plain_fn) in cases.items():
        got, ref = kern(), plain_fn()
        torch.cuda.synchronize()
        if name == "k3_fold_stokes":
            if not torch.equal(got[1], ref[1]):
                raise AssertionError(f"{name}: counts differ")
            err = float((got[0] - ref[0]).abs().max())
            rel = float(((got[0][:, :L] - ref[0][:, :L]).abs()
                         / ref[0][:, :L].abs().clamp_min(1e-30)).max())
            cross = compare((got[0][:, L:],), (ref[0][:, L:],))[1]
            print(f"(i) {name}: power plane rel {rel:.3e}, cross planes "
                  f"{cross:.3e} of their peak; K3 form "
                  f"{dd.k3_form(name, n1, L, pipe.n_phase)}", flush=True)
            ok = rel <= PROFILE_RTOL and cross <= FFT_TOL
            got = got[:1]
        else:
            got, ref = ((got,), (ref,)) if torch.is_tensor(got) else (got, ref)
            err, rel = compare(got, ref)
            ok = rel <= FFT_TOL
        print(f"(i) {name}: max_abs_err={err:.3e} ({'ok' if ok else 'FAIL'})",
              flush=True)
        if not ok or not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{name} disagrees with its plain version")
        del got, ref
        ms, plain_ms = (cuda_ms(f, reps=10) for f in timed[name])
        results[name] = result(err, ms, plain_ms, costs[name])
        print(f"(i) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"bound {results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}) [{gpu}]", flush=True)
        if name in PARENT_MS:
            print(f"(i) {parent_note(name, ms)}, {check_form(name, y)} "
                  f"form [{gpu}]", flush=True)
    return results


def check_guppi_kernels(dev, gpu):
    """Phase (i) at the GUPPI node's shapes: guppi_repack on one (64,
    200,704) block bit for bit against its plain version, and K3 Stokes
    at 2048 bins over 128 lanes of the node's window (its form
    asserted) against its plain version at the 64-bin case's
    tolerances; both timed."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    n, p0, p1 = GUPPI_WINDOW
    t, L, n_phase = n - p0 - p1, 128, 2048
    words = guppi_words(dev, L // 2, t, 70)
    dd.reset_launch_counts()
    got = dd.guppi_repack(words)
    torch.cuda.synchronize()
    ref = dd.guppi_repack_ref(words)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"(i) guppi_repack {tuple(words.shape)}: launches "
          f"{dd.launch_counts['guppi_repack']}, "
          f"{'bit-identical to' if same else 'DIFFERS from'} plain",
          flush=True)
    if not same or dd.launch_counts["guppi_repack"] != 1:
        raise AssertionError("guppi_repack disagrees with its plain version")
    ms, plain_ms = (cuda_ms(lambda f=f: f(words), reps=10)
                    for f in (dd.guppi_repack, dd.guppi_repack_ref))
    results = {"guppi_repack": result(0.0, ms, plain_ms,
                                      ((words,), got, 0))}
    print(f"(i) guppi_repack: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          f"bound {results['guppi_repack']['bound_ms']:.4f} ms "
          f"({results['guppi_repack']['bound_by']}) [{gpu}]", flush=True)
    del words, got, ref
    n1, n2 = dd.split_n(n)
    z = randn(dev, (n2, n1, L), 71)
    fold = torch.as_tensor(dd.fold_phase_vector(0.3, 1.0 / 2434.07),
                           device=dev)
    # the gather form at the node's 2048 bins (the kernels line's
    # k3_fold_gather), the runs form at 1024
    for bins, want, gather in ((n_phase, GUPPI_K3_FORM, 1),
                               (n_phase // 2, GUPPI_K3_RUNS, 0)):
        key = "k3_fold_gather" if gather else f"k3_fold_stokes_{bins}"
        results[key] = check_guppi_k3(dev, gpu, z, fold, bins, want, gather)
    return results


def check_guppi_k3(dev, gpu, z, fold, n_phase, want, gather):
    """K3 Stokes at ``n_phase`` bins on the GUPPI node's window: its form
    (``want``, ``gather`` launches of the gather form counted) asserted,
    against its plain version, timed beside the planes' bytes bound and,
    for the gather form, beside its own (the scratch written and read
    once too)."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    n, p0, p1 = GUPPI_WINDOW
    n2, n1, L = z[0].shape
    t = n - p0 - p1
    form = dd.k3_form("k3_fold_stokes", n1, L, n_phase)
    print(f"(i) k3_fold_stokes at {n_phase} bins, window {GUPPI_WINDOW}: "
          f"K3 form {form}", flush=True)
    if form != want:
        raise AssertionError(f"K3 Stokes at {n_phase} bins: form {form}, "
                             f"want {want}")
    kw = dict(n_phase=n_phase, pad_start=p0, n_valid=t, stokes=True)
    dd.reset_launch_counts()
    prof, cnt = dd.detect_fold(*z, fold, **kw)
    torch.cuda.synchronize()
    rprof, rcnt = dd.fold_ref(*z, fold, **kw)
    if (dd.launch_counts["k3_fold_stokes"] != 1
            or dd.launch_counts["k3_fold_gather"] != gather
            or not torch.equal(cnt, rcnt) or int(cnt[:n_phase].sum()) != t):
        raise AssertionError(f"k3_fold_stokes at {n_phase} bins: launches "
                             f"or counts differ")
    hit = rcnt > 0
    rel = float(((prof[:, :L] - rprof[:, :L]).abs()[hit]
                 / rprof[:, :L].abs()[hit]).max())
    err, cross = compare((prof[:, L:],), (rprof[:, L:],))
    ok = (rel <= PROFILE_RTOL and cross <= FFT_TOL
          and bool(torch.isfinite(prof).all()))
    print(f"(i) k3_fold_stokes at {n_phase} bins: power plane rel "
          f"{rel:.3e}, cross planes {cross:.3e} of their peak "
          f"({'ok' if ok else 'FAIL'})", flush=True)
    if not ok:
        raise AssertionError(f"k3_fold_stokes at {n_phase} bins disagrees "
                             f"with its plain version")
    del prof, cnt, rprof, rcnt
    ms, plain_ms = (cuda_ms(f, reps=10) for f in (
        lambda: dd.detect_fold(*z, fold, **kw),
        lambda: dd.fold_ref(*z, fold, **kw)))
    meta = torch.empty((n_phase + 1, 3 * L + 1), device="meta")
    cost = ((*z, fold), (meta,), fft_flops(z, n1, 11))
    bound_ms, bound_by = bound(*cost)
    note = ""
    if gather:
        zs = torch.empty((n, L), dtype=torch.complex64, device="meta")
        own = bound((*z, fold, zs), (meta, zs), cost[2])[0]
        note = (f", gather form's bound {own:.4f} ms (the scratch written "
                f"and read once)")
    print(f"(i) k3_fold_stokes at {n_phase} bins: {ms:.4f} ms kernel, "
          f"{plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms ({bound_by})"
          f"{note} [{gpu}]", flush=True)
    return result(err, ms, plain_ms, cost)


def drive_guppi(dev, gpu):
    """Phase (j), the GUPPI node's entry: ``run_fn(1)`` on a block of
    device words, its launches counted (guppi_repack, K1p, K2 and K3
    Stokes once each), against the same call on the plain versions,
    timed.  Returns the launch counts."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    node = guppi_node(dev)
    geom = (node._n_fft, node.pad_start, node.pad_end)
    if geom != GUPPI_WINDOW:
        raise AssertionError(f"GUPPI node window {geom}, want "
                             f"{GUPPI_WINDOW}")
    T = node.global_block
    words = guppi_words(dev, node.n_chan, T, 72)
    run = node.run_fn(1, offset0=3 * T, ingest_bits=8)

    def call():
        return run(blocks=words)
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    counts = {k: v for k, v in dd.launch_counts.items() if v}
    expect_launches("run_fn guppi", counts, dict.fromkeys(
        ("guppi_repack", "k1_packed", "k2", "k3_fold_stokes",
         "k3_fold_gather"), 1))
    ref = plain(call)()
    if int(got[1].sum()) != T:
        raise AssertionError(f"run_fn guppi: counts sum "
                             f"{int(got[1].sum())}, want {T}")
    check_profile("run_fn guppi", got, ref, True, gpu)
    best = {}
    for key in ("plain", "kernels", "kernels", "plain"):
        fn = plain(call) if key == "plain" else call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    print(f"(j) run_fn guppi: {1e3 * best['kernels']:.3f} ms/step kernels, "
          f"{1e3 * best['plain']:.3f} ms/step plain [{gpu}]", flush=True)
    return counts


def expect_launches(name, counts, want):
    """The launches of one counted run are exactly ``want``."""
    print(f"(j) {name}: launches {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")


def check_profile(name, got, ref, stokes, gpu, phase="(j)"):
    """Counts exact; power-type planes elementwise within PROFILE_RTOL,
    Stokes cross terms (which cross zero) within FFT_TOL of their peak."""
    (prof, cnt), (rprof, rcnt) = got, ref
    if not torch.equal(cnt, rcnt):
        raise AssertionError(f"{name}: counts differ from plain")
    if not torch.isfinite(prof).all():
        raise AssertionError(f"{name}: profile not finite")
    power = prof[..., :2] if stokes else prof
    rpower = rprof[..., :2] if stokes else rprof
    rel = float(((power - rpower).abs() / rpower.abs()).max())
    cross = (compare((prof[..., 2:],), (rprof[..., 2:],))[1] if stokes
             else 0.0)
    print(f"{phase} {name}: profile {tuple(prof.shape)} vs plain: power rel "
          f"{rel:.3e}, cross {cross:.3e} of the peak [{gpu}]", flush=True)
    if rel > PROFILE_RTOL or cross > FFT_TOL:
        raise AssertionError(f"{name}: profile disagrees with plain")


def drive_variants(dev, gpu):
    """Phase (j): the variants' entry points at the flagship's full
    width, counted, against the plain versions, timed; step_fn on the
    kernels against its torch.fft path.  Returns the launch counts summed
    over the counted runs."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    power, stokes = flagship(dev), flagship(dev, detect="stokes")
    T, ps, n_phase = power.global_block, power.pad_start, power.n_phase
    L = power.n_chan * power.n_pol
    (xf,) = randn(dev, (T, power.n_chan, power.n_pol, 2), 60, count=1)
    x2 = torch.movedim(xf, -1, 0).contiguous()
    window = torch.zeros((2, power._n_fft, L), device=dev)
    window[:, ps:ps + T] = x2.reshape(2, T, L)
    row = power.fold_model.foldv(3 * T, T)      # the polyco's (3,) row
    fold3 = torch.as_tensor(power._shard_fold3(row).astype(np.int32),
                            device=dev)
    t0 = time.perf_counter()
    cfg = config_pipeline("flagship_fold")
    bins = power.phase_bins(cfg["phase_model"], cfg["start_time"], 3 * T)
    print(f"(j) phase_bins of {T} samples from the polyco: "
          f"{time.perf_counter() - t0:.3f} s on the host", flush=True)
    csr, csi = power._chirp_device()
    theta = stokes._theta_device()
    fold_pow2 = dd.dedisperse_fold_pow2
    # run_fn's set-up (the polyco's fold rows on the host, then on the
    # card) is made once, as phase (c) does; its payload on first call
    t0 = time.perf_counter()
    run_stokes = stokes.run_fn(N_ITER, ingest_bits=8)
    print(f"(j) run_fn Stokes set-up ({N_ITER} fold rows): "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms on the host", flush=True)
    # name -> (call, steps, detect, launches it must make, one each step)
    paths = {
        "run_fn_stokes": (lambda: run_stokes(seed=0), N_ITER, "stokes",
                          ("k1_packed", "k2", "k3_fold_stokes")),
        "step_fn": (lambda: power.step_fn()(xf, row), 1, "power",
                    ("k1_window", "k2", "k3_power")),
        "step_fn_stokes": (lambda: stokes.step_fn()(xf, row), 1, "stokes",
                           ("k1_window", "k2", "k3_trim")),
        "step_bins_fn": (lambda: power.step_bins_fn()(xf, bins), 1, "power",
                         ("k1_window", "k2", "k3_power")),
        "planes_step": (lambda: power.planes_step(x2, csr, csi, 300, row), 1,
                        "power", ("k1_stream_planes", "k2", "k3_fold")),
        "planes_step_theta_stokes": (
            lambda: stokes.planes_step(x2, theta, None, 300, row), 1,
            "stokes", ("k1_stream_planes", "k2_theta", "k3_fold_stokes")),
        "dedisperse_fold_pow2": (
            lambda: fold_pow2(window, csr, csi, fold3, n_phase=n_phase,
                              pad_start=ps, n_valid=T), 1, "raw",
            ("k1_planes", "k2", "k3_fold")),
    }
    launches = dict.fromkeys(dd.launch_counts, 0)
    for name, (call, steps, detect, needs) in paths.items():
        torch.cuda.synchronize()
        dd.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        counts = {k: v for k, v in dd.launch_counts.items() if v}
        expect_launches(name, counts, dict.fromkeys(needs, steps))
        for k, v in counts.items():
            launches[k] += v
        ref = plain(call)()
        if detect == "raw":        # the op's (n_phase+1, L) profile
            got = (got[0][:n_phase], got[1][:n_phase])
            ref = (ref[0][:n_phase], ref[1][:n_phase])
        total = int(got[1].sum())
        if total != steps * T:
            raise AssertionError(f"{name}: counts sum {total}, want "
                                 f"{steps * T}")
        check_profile(name, got, ref, detect == "stokes", gpu)
        best = {}
        for key in ("plain", "kernels", "kernels", "plain"):
            fn = plain(call) if key == "plain" else call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
        print(f"(j) {name}: {1e3 * best['kernels'] / steps:.3f} ms/step "
              f"kernels, {1e3 * best['plain'] / steps:.3f} ms/step plain "
              f"[{gpu}]", flush=True)
    # where run_fn Stokes' step goes: one profiled turn, and one call that
    # also builds run_fn (fold rows, payload) as a fresh caller would
    wall, busy, rows = device_profile(lambda: run_stokes(seed=0))
    print(f"(j) run_fn Stokes profiled turn: {wall / N_ITER:.3f} ms/step "
          f"wall, {busy / N_ITER:.3f} ms/step device busy "
          f"({busy / wall:.2f}) [{gpu}]", flush=True)
    for dev_us, count, key in rows[:8]:
        print(f"(j)   {dev_us / 1e3 / N_ITER:8.3f} ms/step  x{count:<3d} "
              f"{key[:80]}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stokes.run_fn(N_ITER, ingest_bits=8)(seed=0)
    torch.cuda.synchronize()
    print(f"(j) run_fn Stokes built and run in one call: "
          f"{1e3 * (time.perf_counter() - t0) / N_ITER:.3f} ms/step [{gpu}]",
          flush=True)
    # step_fn's XLA path: torch.fft on the same power-of-two window
    for detect, kern in (("power", power), ("stokes", stokes)):
        xla = flagship(dev, use_kernels=False, fft_pow2=True, detect=detect)
        if (xla._n_fft, xla.pad_start, xla.global_block) != (
                kern._n_fft, ps, T):
            raise AssertionError("the torch.fft path's geometry differs")
        dd.reset_launch_counts()
        prof, cnt = xla.step_fn()(xf, row)
        torch.cuda.synchronize()
        expect_launches(f"step_fn {detect} on torch.fft",
                        {k: v for k, v in dd.launch_counts.items() if v}, {})
        kprof, kcnt = kern.step_fn()(xf, row)
        worst = float(((kprof - prof).abs() / (1e-2 + 1e-3 * prof.abs())
                       ).max())
        best = {}
        for key, fn in (("xla", xla), ("kernels", kern), ("kernels", kern),
                        ("xla", xla)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn.step_fn()(xf, row)
            torch.cuda.synchronize()
            best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
        print(f"(j) step_fn {detect}: kernels vs torch.fft path {worst:.3f} "
              f"of the rtol 1e-3 / atol 1e-2 bound; "
              f"{1e3 * best['kernels']:.3f} ms/step kernels, {1e3 * best['xla']:.3f} ms/step torch.fft "
              f"[{gpu}]", flush=True)
        if not torch.equal(cnt, kcnt) or worst > 1.0:
            raise AssertionError(f"step_fn {detect}: kernels disagree with "
                                 f"the torch.fft path")
        del xla
    return launches


# -- the searches and the resident op: phases (k), (l) and (m) --------------

SEARCH_N = 1 << 22           # tools/bench_full.py accel(): 2^22 samples,
SEARCH_KW = dict(z_max=64, z_step=2)   # 1 MHz, z_max 64 step 2: 65 trials
SEG_LEN = {"auto": 4096, "mx": 4096, "pallas": 4096, "xla": 8192}
TONE_F0, TONE_Z = (1 << 20) + 1234, 12.0   # mid-band bin, drift in bins
TONE_AMP = 0.05              # ~2600 in the noise-normalized map at 2^22
FFA_BASE, FFA_TRUE = 1000, 1024            # base period, trial injected
FFA_AMP = 0.2                # a 10-sample pulse: S/N ~40 over 4096 turns
RESIDENT_T = 261120          # tools/bench_resident.py's block (2^18 - 1024)
RESIDENT_PAD = 256           # covers the ~95-sample DM-500 channel smear
RESIDENT_WINDOWS = (2048, 4096)
# the three-pass chain on the same block: one window of SPLIT_N rows
SPLIT_N = 1 << 18


def accel_search(dev, engine):
    from baseband_tasks_tpu_torch import FourierDomainAccelSearch, units as u
    return FourierDomainAccelSearch(SEARCH_N, 1 * u.MHz, seg_len=SEG_LEN[engine],
                                    engine=engine, device=dev, **SEARCH_KW)


def ffa_trials():
    """The FFA's trial count m over the search series at FFA_BASE."""
    return 1 << ((SEARCH_N // FFA_BASE).bit_length() - 1)


def search_series(dev):
    """The smoke's search input on the card: unit noise (numpy seed 21) plus
    a tone at bin TONE_F0 drifting TONE_Z bins, amplitude TONE_AMP, and a pulse
    train of period FFA_BASE + FFA_TRUE/(m-1) samples, 10 samples wide,
    amplitude FFA_AMP (for the FFA; its harmonics stay under the accel
    candidates' threshold)."""
    rng = np.random.default_rng(21)
    t = np.arange(SEARCH_N) / SEARCH_N
    x = rng.standard_normal(SEARCH_N)
    x += TONE_AMP * np.cos(2 * np.pi * (TONE_F0 * t + 0.5 * TONE_Z * t ** 2))
    period = FFA_BASE + FFA_TRUE / (ffa_trials() - 1)
    x[(np.arange(SEARCH_N) % period) < 10] += FFA_AMP
    return torch.as_tensor(x.astype(np.float32), device=dev)


def chirp_planes(dev, n, fir_seed=None):
    """d-major (N2, N1, L) float32 planes at the flagship's width (64
    channels x 2 pols) of the dedispersion chirp at window length ``n``:
    the flagship's DM-500 chirp (``WidebandPulsarPipeline._build_chirp``
    at ``n``) referred to each channel's own centre, so that it holds the
    ~95-sample smear within a channel and not the bulk delays between
    channels (up to ~3000 samples, which the flagship's 3584/4608-row pads
    cover and 256-row pads cannot), or, with ``fir_seed``, the response of a random FIR with
    support [-100, 200] inside the pads (``make_case`` of
    tests/test_dedisperse_resident.py), the same taps at every ``n``, at
    which overlap-save is exact for every window size."""
    from baseband_tasks_tpu_torch import units as u
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    pipe = flagship_on_host()
    L = pipe.n_chan * pipe.n_pol
    if fir_seed is not None:
        rng = np.random.default_rng(fir_seed)
        taps = (rng.normal(size=(301, L)) + 1j * rng.normal(size=(301, L))
                ) / np.sqrt(301.0)
        h = torch.zeros((n, L), dtype=torch.complex64, device=dev)
        h[:201] = torch.as_tensor(taps[:201].astype(np.complex64), device=dev)
        h[-100:] = torch.as_tensor(taps[201:].astype(np.complex64),
                                   device=dev)
        chirp = torch.fft.fft(h, dim=0)
    else:
        offsets = np.fft.fftfreq(n) * pipe.chan_rate.to_value(u.MHz)
        f_sky = pipe.freqs.to_value(u.MHz)[None, :] + offsets[:, None]
        cyc = np.asarray(pipe.dm.phase_delay(
            u.Quantity(f_sky, u.MHz), pipe.freqs[None, :]
        ).to_value(u.cycle), np.float64)
        cyc -= np.round(cyc)
        chirp = torch.as_tensor(np.repeat(np.exp(-2j * np.pi * cyc).astype(
            np.complex64), pipe.n_pol, axis=1), device=dev)
    n1, n2 = dd.split_n(n)
    chirp = chirp.reshape(n2, n1, L)         # permute_to_storage_order
    return [chirp.real.contiguous(), chirp.imag.contiguous()]


def resident_case(dev, n_window, seed, fir_seed=None):
    """The resident op's inputs at the flagship's width (L = 128, 64 phase
    bins) on a block of RESIDENT_T rows cut to a multiple of hop: random
    planes and halos, the chirp at the window length (:func:`chirp_planes`)
    and a fold row."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.ops.dedisperse_resident import (
        resident_geometry)
    L = 128
    hop, _, _ = resident_geometry(n_window, RESIDENT_PAD, RESIDENT_PAD)
    T = RESIDENT_T // hop * hop
    fold = torch.as_tensor(dd.fold_phase_vector(0.123, 1.0 / 1607.3),
                           device=dev)
    return dict(x=randn(dev, (T, L), seed),
                front=randn(dev, (RESIDENT_PAD, L), seed + 1),
                end=randn(dev, (RESIDENT_PAD, L), seed + 2),
                chirp=chirp_planes(dev, n_window, fir_seed), fold=fold,
                scale=torch.tensor([0.5], device=dev), n_window=n_window,
                n_phase=64, T=T, L=L, fir_seed=fir_seed)


def resident_call(case, stokes, engine="stockham"):
    from baseband_tasks_tpu_torch.ops.dedisperse_resident import (
        dedisperse_fold_resident)
    c = case
    return lambda: dedisperse_fold_resident(
        *c["x"], *c["front"], *c["end"], *c["chirp"], c["fold"], c["scale"],
        n_window=c["n_window"], n_phase=c["n_phase"], pad_start=RESIDENT_PAD,
        pad_end=RESIDENT_PAD, stokes=stokes, engine=engine)


def split_call(case, stokes, chirp):
    """The port's three-pass dedisperse_fold_split on the same block: one
    SPLIT_N-row window, the pads (SPLIT_N - T)/2 each, the halos zero-extended
    and i0 shifted in fixed point to the later resident t = 0 (the
    construction of tests/test_dedisperse_resident.py); ``chirp`` its
    d-major planes at SPLIT_N."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    c = case
    T, L, dev = c["T"], c["L"], c["x"][0].device
    pad = (SPLIT_N - T) // 2
    shift = pad - RESIDENT_PAD
    fr, er = (torch.zeros((2, pad, L), device=dev) for _ in (0, 1))
    fr[:, shift:] = torch.stack(c["front"])
    er[:, :RESIDENT_PAD] = torch.stack(c["end"])
    fold = c["fold"].cpu().numpy().astype(np.int64)
    i0 = (fold[0] - shift * fold[1]) & dd._FX_MASK
    fold = torch.tensor([i0, fold[1], 0], dtype=torch.int32, device=dev)
    return lambda: dd.dedisperse_fold_split(
        *c["x"], fr[0], fr[1], er[0], er[1], *chirp, fold, c["scale"],
        n_phase=c["n_phase"], pad_start=pad, n_valid=T, stokes=stokes)


def check_resident(tag, got, ref, L, gpu):
    """A resident profile against another of the same op: counts exact,
    the power plane elementwise within PROFILE_RTOL, the Stokes cross
    planes (which cross zero) within FFT_TOL of their peak.  Returns the
    max abs error."""
    (prof, cnt), (rprof, rcnt) = got, ref
    torch.cuda.synchronize()
    if not torch.equal(cnt, rcnt) or not torch.isfinite(prof).all():
        raise AssertionError(f"{tag}: counts differ or profile not finite")
    rel = float(((prof[:, :L] - rprof[:, :L]).abs()
                 / rprof[:, :L].abs()).max())
    cross = (compare((prof[:, L:],), (rprof[:, L:],))[1]
             if prof.shape[1] > L else 0.0)
    print(f"{tag}: profile {tuple(prof.shape)} vs plain: power rel "
          f"{rel:.3e}, cross {cross:.3e} of the peak, counts exact [{gpu}]",
          flush=True)
    if rel > PROFILE_RTOL or cross > FFT_TOL:
        raise AssertionError(f"{tag}: profile disagrees")
    return float((prof - rprof).abs().max())


def accel_cost(segs, valid, lanes):
    """accel_corr's (reads, writes, FP32 operations) for ``lanes`` lanes:
    the segment spectra and the lanes' templates read, the (n_seg, valid,
    lanes) map written, a seg_len-point FFT, the product and |.|^2 per
    (segment, lane) point."""
    n_seg, seg_len = segs.shape
    meta = dict(device="meta")
    return ((segs, torch.empty((seg_len, lanes), dtype=torch.complex64,
                               **meta)),
            (torch.empty((n_seg, valid, lanes), **meta),),
            n_seg * seg_len * lanes * (5 * np.log2(seg_len) + 6))


def time_public_accel(segs, tr, ti, valid, n_used, res, gpu):
    """The public accel_correlate_bank at its 128 lanes (zero templates
    past the search's), against its plain version and timed beside the
    library call and its own bound; the bounds of both lane counts."""
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    got = ac.accel_correlate_bank(segs, tr, ti, valid=valid)
    ref = ac.accel_correlate_bank_ref(segs, tr, ti, valid=valid)
    err, rel = compare((got,), (ref,))
    pad = float(got[..., n_used:].abs().max())
    print(f"(k) accel_corr public op {tuple(got.shape)}: rel {rel:.3e}, "
          f"zero-template lanes max {pad:.1e}", flush=True)
    if rel > FFT_TOL or pad != 0.0:
        raise AssertionError("accel_correlate_bank disagrees")
    del got, ref
    prod = (segs[:, None, :] * torch.complex(tr, ti).T[None]).contiguous()
    ms, lib_ms = (cuda_ms(f, reps=5) for f in (
        lambda: ac.accel_correlate_bank(segs, tr, ti, valid=valid),
        lambda: torch.fft.ifft(prod, dim=-1).abs() ** 2))
    del prod
    full = bound(*accel_cost(segs, valid, ac.LANES))[0]
    print(f"(k) accel_corr: {n_used} used lanes {res['ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms (bytes), library "
          f"{res['library_ms']:.4f} ms; public op at {ac.LANES} lanes "
          f"{ms:.4f} ms, bound {full:.4f} ms (bytes), library {lib_ms:.4f} "
          f"ms [{gpu}]", flush=True)


def check_search_kernels(dev, gpu):
    """Phase (k): bank_power, accel_corr and resident against their plain
    versions at the shapes of the search and resident paths, timed with
    CUDA events, with the one PyTorch call computing the same function
    where there is one."""
    from baseband_tasks_tpu_torch.ops import accel_correlate as ac
    from baseband_tasks_tpu_torch.ops.dedisperse_resident import (
        resident_form)
    mx = accel_search(dev, "mx")
    ka, kb, kc = mx._mx_fused_planes()
    n_seg = -(-mx.n_freq // mx.m)
    n_seg = -(-n_seg // 256) * 256           # padded to the 256-row tile
    fr, fi = randn(dev, (n_seg, 2 * mx.m), 80)
    pal = accel_search(dev, "pallas")
    (tr, ti), n_used = pal._lane_banks()[0]   # the search's used lanes
    sr, si = randn(dev, (pal._n_seg, pal.seg_len), 81)
    segs = torch.complex(sr, si)
    valid = pal._valid
    # the library yardsticks: one complex matmul and |.|^2; one cuFFT
    # inverse FFT of the bank product (the used lanes), lanes outer, and
    # |.|^2
    op = torch.complex(ka, kb - ka)
    sc = torch.complex(fr, fi)
    prod = (segs[:, None, :]
            * torch.complex(tr, ti).T[None, :n_used]).contiguous()
    cases = {
        "bank_power": (lambda: ac.bank_matmul_power(fr, fi, ka, kb, kc),
                       lambda: ac.bank_matmul_power_ref(fr, fi, ka, kb, kc),
                       lambda: (sc @ op).abs() ** 2,
                       tf32x3_cost(
                           (fr, fi, ka, kb, kc),
                           (torch.empty((n_seg, ka.shape[1]), device="meta"),),
                           3 * 2 * n_seg * ka.shape[0] * ka.shape[1])),
        # the search's path: the used lanes only
        "accel_corr": (lambda: ac._accel_correlate_lanes(
                           segs, tr, ti, valid=valid, n_used=n_used),
                       lambda: ac._accel_correlate_lanes_ref(
                           segs, tr, ti, valid=valid, n_used=n_used),
                       lambda: torch.fft.ifft(prod, dim=-1).abs() ** 2,
                       accel_cost(segs, valid, n_used)),
    }
    results = {}
    full_fp32()
    for name, (kern, plain_fn, lib, cost) in cases.items():
        got, ref = kern(), plain_fn()
        torch.cuda.synchronize()
        err, rel = compare((got,), (ref,))
        ok = rel <= FFT_TOL and bool(torch.isfinite(got).all())
        print(f"(k) {name}: {tuple(got.shape)} max_abs_err={err:.3e} "
              f"rel={rel:.3e} ({'ok' if ok else 'FAIL'})", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        del got, ref
        ms, plain_ms, lib_ms = (cuda_ms(f, reps=5) for f in (kern, plain_fn,
                                                             lib))
        results[name] = result(err, ms, plain_ms, cost, lib_ms)
        print(f"(k) {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"{lib_ms:.4f} ms library, bound "
              f"{results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}) [{gpu}]", flush=True)
        if name == "accel_corr":
            time_public_accel(segs, tr, ti, valid, n_used, res=results[name],
                              gpu=gpu)
        if name == "bank_power":
            print(f"(k) bank_power: {both_bounds(cost)}", flush=True)
            got = ac.bank_matmul_power(fr[:256], fi[:256], ka, kb, kc)
            ref = ac.bank_matmul_power_ref(*(t.double() for t in (
                fr[:256], fi[:256], ka, kb, kc)))
            rel = compare((got,), (ref,))[1]
            print(f"(k) bank_power 256 rows against float64: rel {rel:.3e} "
                  f"(limit {TF32X3_TOL:g})", flush=True)
            if not rel <= TF32X3_TOL:
                raise AssertionError("bank_power is not float32-class "
                                     "against float64")
            del got, ref
    del mx, pal, ka, kb, kc, fr, fi, op, sc, prod, segs
    torch.cuda.empty_cache()
    for n_window in RESIDENT_WINDOWS:
        case = resident_case(dev, n_window, 82)
        T, L = case["T"], case["L"]
        for stokes in (False, True):
            kern, plain_fn = resident_call(case, stokes), plain(
                resident_call(case, stokes))
            tag = f"resident N={n_window} {'stokes' if stokes else 'power'}"
            (prof, cnt), ref = kern(), plain_fn()
            err = check_resident(f"(k) {tag}", (prof, cnt), ref, L, gpu)
            if int(cnt.sum()) != T // (n_window - 2 * RESIDENT_PAD) * n_window:
                raise AssertionError(f"{tag}: counts do not sum to the rows")
            ms, plain_ms = (cuda_ms(f, reps=10) for f in (kern, plain_fn))
            # the function needs the block, both halos and the chirp once
            # (the kernel reads the pads twice: not counted); per element
            # of every window's rows two FFTs, the scale and chirp,
            # detection
            rows = T // (n_window - 2 * RESIDENT_PAD) * n_window
            cost = ((*case["x"], *case["front"], *case["end"], *case["chirp"],
                     case["fold"], case["scale"]),
                    (prof, cnt), rows * L * (10 * np.log2(n_window) + 8
                                             + (12 if stokes else 3)))
            res = result(err, ms, plain_ms, cost)
            form = resident_form(n_window, L, case["n_phase"], stokes)
            if form != "register":
                raise AssertionError(f"{tag} runs the {form} form")
            print(f"(k) {tag}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
                  f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
                  f"{T} rows, {form} form [{gpu}]", flush=True)
            print(f"(k) {parent_note(tag, ms)} [{gpu}]", flush=True)
            if n_window == RESIDENT_WINDOWS[0] and not stokes:
                results["resident"] = res
        del case
    return results


def drive_search(dev, gpu):
    """Phase (l): the acceleration search at full width on 'auto' (which
    must be 'pallas' on the card), 'mx' (by name: bank_power launched),
    'pallas' and 'xla', launches counted, held against each other at the
    JAX package's engine bounds, the tone found by every engine's map and
    by 'auto''s harmonic_sum and candidates; each engine timed against its plain
    versions in turns; then the FFA on the card against the same call on
    the CPU.  Returns the launch counts summed over the counted runs."""
    from baseband_tasks_tpu_torch import FastFoldingSearch, units as u
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    full_fp32()
    x = search_series(dev)
    searches = {e: accel_search(dev, e)
                for e in ("auto", "mx", "pallas", "xla")}
    if searches["auto"]._engine() != "pallas":
        raise AssertionError("'auto' did not pick 'pallas' on the card")
    expect = {"auto": {"accel_corr": 1}, "mx": {"bank_power": 1},
              "pallas": {"accel_corr": 1}, "xla": {}}
    launches, maps = dict.fromkeys(dd.launch_counts, 0), {}
    for engine, s in searches.items():
        torch.cuda.synchronize()
        dd.reset_launch_counts()
        maps[engine] = s.search(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in dd.launch_counts.items() if v}
        print(f"(l) search '{engine}': map {tuple(maps[engine].shape)}, "
              f"launches {counts}", flush=True)
        if counts != expect[engine]:
            raise AssertionError(f"search '{engine}': launches {counts}")
        for k, v in counts.items():
            launches[k] += v
    ref = maps["xla"]
    for engine, tol in (("mx", 2e-4), ("auto", 2e-3), ("pallas", 2e-3)):
        got = maps[engine]
        ratio = float(((got - ref).abs() / (tol + tol * ref.abs())).max())
        print(f"(l) '{engine}' vs 'xla': {ratio:.3f} of the rtol/atol "
              f"{tol:g} bound [{gpu}]", flush=True)
        if ratio > 1.0 or got.shape != ref.shape or not torch.isfinite(
                got).all():
            raise AssertionError(f"search '{engine}' disagrees with 'xla'")
    s = searches["auto"]
    for engine, m in maps.items():
        zm = m.cpu().numpy()
        pi, pj = np.unravel_index(np.argmax(zm[16:]), zm[16:].shape)
        print(f"(l) '{engine}' map peak ({pi + 16}, {s.z_values[pj]})",
              flush=True)
        if abs(pi + 16 - TONE_F0) > 1 or abs(s.z_values[pj] - TONE_Z) > 2:
            raise AssertionError(f"search '{engine}': tone not at its peak")
    zmap = maps["auto"].cpu().numpy()
    i, j = np.unravel_index(np.argmax(zmap[16:]), zmap[16:].shape)
    hmap = s.harmonic_sum(zmap, n_harm=4)
    hi, hj = np.unravel_index(np.argmax(hmap[16:]), hmap[16:].shape)
    cands = s.candidates(x)
    print(f"(l) tone at bin {TONE_F0}, z {TONE_Z}: map peak ({i + 16}, "
          f"{s.z_values[j]}) power {zmap[i + 16, j]:.1f}; harmonic sum peak "
          f"({hi + 16}, {s.z_values[hj]}); candidates "
          f"{[(round(f.to_value(u.Hz) * SEARCH_N / 1e6), z, round(p, 1)) for f, z, p in cands[:3]]}",
          flush=True)
    found = cands and abs(cands[0][0].to_value(u.Hz) * SEARCH_N / 1e6
                          - TONE_F0) <= 1
    # a pure tone also lights the sums at its sub-harmonics f0/k, z/k
    sub = any(abs((hi + 16) * k - TONE_F0) <= k
              and abs(s.z_values[hj] * k - TONE_Z) <= 2 * k for k in (1, 2, 3, 4))
    if (abs(i + 16 - TONE_F0) > 1 or abs(s.z_values[j] - TONE_Z) > 2
            or not sub or not found or abs(cands[0][1] - TONE_Z) > 2):
        raise AssertionError("the search did not recover the tone")
    del maps, zmap, hmap
    samples = SEARCH_N * len(s.zs)
    for engine, srch in searches.items():
        best = {}
        for key in ("plain", "kernels", "kernels", "plain"):
            fn = plain(srch.search) if key == "plain" else srch.search
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
        print(f"(l) search '{engine}': {1e3 * best['kernels']:.3f} ms kernels, "
              f"{1e3 * best['plain']:.3f} ms plain, "
              f"{samples / best['kernels']:.4e} sample-trials/s [{gpu}]",
              flush=True)
    # 'pallas' with the bank over four virtual shards of the card: each
    # shard's chunk computes only its own templates
    from baseband_tasks_tpu_torch.parallel import Mesh
    srch, zmesh = searches["pallas"], Mesh([dev] * 4, ("z",))
    srch.search_sharded(x, zmesh)             # builds the shards' banks
    best = min(cuda_ms(lambda: srch.search_sharded(x, zmesh), reps=3)
               for _ in range(2))
    print(f"(l) search_sharded 'pallas' over 4 shards: {best:.3f} ms "
          f"[{gpu}]", flush=True)
    del searches, srch
    torch.cuda.empty_cache()
    ffa = FastFoldingSearch(FFA_BASE, SEARCH_N)
    if ffa.device.type != dev.type or ffa.m != ffa_trials():
        raise AssertionError("FastFoldingSearch: not on the card / m wrong")
    snr = ffa.snr(x)
    cpu = FastFoldingSearch(FFA_BASE, SEARCH_N, device="cpu").snr(x.cpu())
    torch.cuda.synchronize()
    worst = float(((snr.cpu() - cpu).abs() / (1e-3 + 1e-4 * cpu.abs())).max())
    best = int(snr.argmax())
    cands = ffa.candidates(x, threshold=20.0)
    print(f"(l) FFA p {FFA_BASE}, {ffa.m} trials: best trial {best} "
          f"(injected {FFA_TRUE}) S/N {float(snr[best]):.1f}; card vs CPU "
          f"{worst:.3f} of the rtol 1e-4 / atol 1e-3 bound; "
          f"{len(cands)} candidates over S/N 20", flush=True)
    # trial s drifts the pulse s/(m-1) samples per turn; the ladder's
    # rounded shifts may put the peak a few trials off (within the widest
    # 16-bin boxcar over the series)
    if (worst > 1.0 or abs(best - FFA_TRUE) > 8 or not cands
            or cands[0]["trial"] != best):
        raise AssertionError("FFA wrong on the card")
    ms = cuda_ms(lambda: ffa.snr(x), reps=5)
    fold_ms = cuda_ms(lambda: ffa.fold(x), reps=5)
    print(f"(l) FFA on the card: snr {ms:.3f} ms, fold {fold_ms:.3f} ms "
          f"[{gpu}]", flush=True)
    return launches


def drive_resident(dev, gpu):
    """Phase (m): dedisperse_fold_resident at the flagship's width, both
    engines, power and Stokes, against the plain versions on the card and
    against the port's three-pass dedisperse_fold_split on the same block
    (to 5e-4 of the peak, the JAX test's bound, on an FIR inside the pads,
    where overlap-save is exact at both window sizes, and on the DM-500
    chirp, whose tails past the pads the bound covers at this block's
    ~4000 samples per bin), and timed against it in turns.  Returns the
    resident launches."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    launches = 0
    dm_big = chirp_planes(dev, SPLIT_N)
    fir_big = chirp_planes(dev, SPLIT_N, fir_seed=3)
    for n_window in RESIDENT_WINDOWS:
        case = resident_case(dev, n_window, 90)
        fir = resident_case(dev, n_window, 90, fir_seed=3)
        for stokes in (False, True):
            tag = f"N={n_window} {'stokes' if stokes else 'power'}"
            for engine in ("stockham", "mxu"):
                call = resident_call(case, stokes, engine)
                torch.cuda.synchronize()
                dd.reset_launch_counts()
                got = call()
                torch.cuda.synchronize()
                counts = {k: v for k, v in dd.launch_counts.items() if v}
                if counts != {"resident": 1}:
                    raise AssertionError(f"resident {tag} {engine}: "
                                         f"launches {counts}")
                launches += 1
                check_resident(f"(m) resident {tag} {engine}", got,
                               plain(call)(), case["L"], gpu)
                del got
            n_phase = case["n_phase"]
            for name, c, big in (("FIR", fir, fir_big),
                                 ("DM-500", case, dm_big)):
                (rp, rc), (sp, sc) = (resident_call(c, stokes)(),
                                      split_call(c, stokes, big)())
                torch.cuda.synchronize()
                exact = torch.equal(rc[:n_phase], sc[:n_phase])
                rel = compare((rp[:n_phase],), (sp[:n_phase],))[1]
                print(f"(m) resident {tag} vs three-pass, {name} chirp: "
                      f"counts {'exact' if exact else 'DIFFER'}, profile "
                      f"{rel:.3e} of the peak [{gpu}]", flush=True)
                if not exact or rel > 5e-4:
                    raise AssertionError(f"resident {tag} disagrees with "
                                         f"the three-pass chain")
            calls = {"three-pass": split_call(case, stokes, dm_big),
                     "resident": resident_call(case, stokes)}
            best = {}
            for key in ("three-pass", "resident", "resident", "three-pass"):
                best[key] = min(best.get(key, np.inf),
                                cuda_ms(calls[key], reps=10))
            samples = case["T"] * case["L"]
            print(f"(m) {tag}: resident {best['resident']:.4f} ms, "
                  f"three-pass {best['three-pass']:.4f} ms on the same "
                  f"{case['T']} x {case['L']} block: "
                  f"{1e3 * samples / best['resident']:.4e} vs "
                  f"{1e3 * samples / best['three-pass']:.4e} samples/s "
                  f"[{gpu}]", flush=True)
            wins = best["resident"] < best["three-pass"]
            print(f"(m) {tag}: the resident op "
                  f"{'beats' if wins else 'does not beat'} the three-pass "
                  f"chain, {best['three-pass'] / best['resident']:.2f}x "
                  f"[{gpu}]", flush=True)
        del case, fir
        torch.cuda.empty_cache()
    return launches


# -- bf16 intermediates and integration: phases (n) and (o) ----------------

BF16_KERNELS = ("k1_packed_bf16", "k1_float_bf16", "k2_bf16", "k2_bf16_chirp",
                "k3_fold_bf16", "k3_fold_stokes_bf16")
# the bf16 profile bar of TestBF16Intermediates (tests/test_pallas_kernels.py)
BF16_PROFILE_TOL = 1e-3


def check_bf16_planes(name, got, ref):
    """bf16 planes of a kernel against its plain version's: within one bf16
    ulp of the plain value plus 1e-6 of the peak (the float32 values
    before rounding differ by FFT roundoff, so a rounding may land on the
    neighbouring bf16 value).  Returns the max abs error."""
    torch.cuda.synchronize()
    peak = max(float(r.float().abs().max()) for r in ref)
    err, worst, flips = 0.0, 0.0, 0
    for g, r in zip(got, ref):
        if g.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: planes are not bf16")
        g, r = g.float(), r.float()
        d = (g - r).abs()
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
                         - 7)
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (ulp + 1e-6 * peak)).max()))
        flips += int((d > 0).sum())
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: planes not finite")
    print(f"(n) {name}: max_abs_err={err:.3e}, {worst:.3f} of the 1-ulp "
          f"bound, {flips} of {2 * got[0].numel()} roundings differ "
          f"({'ok' if worst <= 1.0 else 'FAIL'})", flush=True)
    if worst > 1.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_bf16_kernels(pipe, gpu):
    """Phase (n), kernels: each bf16 pass against its plain bf16 version
    at the flagship shapes, timed beside its float32 kernel."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    bf = torch.bfloat16
    L = pipe.n_chan * pipe.n_pol
    T = pipe.global_block
    words, planes, edges, scale, (csr, csi), fold = flagship_inputs(pipe)
    chirp16 = (csr.to(bf), csi.to(bf))
    kw = dict(n_phase=pipe.n_phase, pad_start=pipe.pad_start, n_valid=T)
    y16 = dd.stage_a_packed_ref(*words, *edges, scale, bits=8, out_dtype=bf)
    y32 = dd.stage_a_packed_ref(*words, *edges, scale, bits=8)
    z16 = dd.stage_b_ref(*[p.clone() for p in y16], csr, csi)
    z32 = dd.stage_b_ref(*[p.clone() for p in y32], csr, csi)
    n2, n1 = y16[0].shape[:2]
    # name -> (kernel, plain bf16 version, float32 kernel)
    cases = {
        "k1_packed_bf16": (
            lambda: dd.stage_a_packed(*words, *edges, scale, bits=8,
                                      out_dtype=bf),
            lambda: dd.stage_a_packed_ref(*words, *edges, scale, bits=8,
                                          out_dtype=bf),
            lambda: dd.stage_a_packed(*words, *edges, scale, bits=8)),
        "k1_float_bf16": (
            lambda: dd.stage_a(*planes, *edges, scale, out_dtype=bf),
            lambda: dd.stage_a_ref(*planes, *edges, scale, out_dtype=bf),
            lambda: dd.stage_a(*planes, *edges, scale)),
        "k2_bf16": (
            lambda: dd.stage_b(*[p.clone() for p in y16], csr, csi),
            lambda: dd.stage_b_ref(*[p.clone() for p in y16], csr, csi),
            None),
        "k2_bf16_chirp": (
            lambda: dd.stage_b(*[p.clone() for p in y16], *chirp16),
            lambda: dd.stage_b_ref(*[p.clone() for p in y16], *chirp16),
            None),
        "k3_fold_bf16": (lambda: dd.detect_fold(*z16, fold, **kw),
                         lambda: dd.fold_ref(*z16, fold, **kw),
                         lambda: dd.detect_fold(*z32, fold, **kw)),
        "k3_fold_stokes_bf16": (
            lambda: dd.detect_fold(*z16, fold, stokes=True, **kw),
            lambda: dd.fold_ref(*z16, fold, stokes=True, **kw),
            lambda: dd.detect_fold(*z32, fold, stokes=True, **kw)),
    }
    # stage B timed in place on scratch copies (unit-modulus chirp)
    w16, w32 = [p.clone() for p in y16], [p.clone() for p in y32]
    timed = dict(cases)
    timed["k2_bf16"] = (lambda: dd.stage_b(*w16, csr, csi),
                        lambda: dd.stage_b_ref(*w16, csr, csi),
                        lambda: dd.stage_b(*w32, csr, csi))
    timed["k2_bf16_chirp"] = (lambda: dd.stage_b(*w16, *chirp16),
                              lambda: dd.stage_b_ref(*w16, *chirp16),
                              lambda: dd.stage_b(*w32, csr, csi))
    meta = dict(device="meta")
    prof_out = torch.empty((pipe.n_phase + 1, L + 1), **meta)
    stokes_out = torch.empty((pipe.n_phase + 1, 3 * L + 1), **meta)
    k2_ops = fft_flops(y16, n2, 10 * np.log2(n2) + 12)
    costs = {   # (reads, writes, FP32 operations), from the planes' dtypes
        "k1_packed_bf16": ((*words, *edges, scale), y16, fft_flops(y16, n1)),
        "k1_float_bf16": ((*planes, *edges, scale), y16, fft_flops(y16, n1)),
        "k2_bf16": ((*y16, csr, csi), y16, k2_ops),
        "k2_bf16_chirp": ((*y16, *chirp16), y16, k2_ops),
        "k3_fold_bf16": ((*z16, fold), (prof_out,), fft_flops(z16, n1, 5)),
        "k3_fold_stokes_bf16": ((*z16, fold), (stokes_out,),
                                fft_flops(z16, n1, 11)),
    }
    results = {}
    for name, (kern, plain_fn, _) in cases.items():
        got, ref = kern(), plain_fn()
        if name.startswith("k3"):
            torch.cuda.synchronize()
            if not torch.equal(got[1], ref[1]):
                raise AssertionError(f"{name}: counts differ")
            err = float((got[0] - ref[0]).abs().max())
            rel = float(((got[0][:, :L] - ref[0][:, :L]).abs()
                         / ref[0][:, :L].abs().clamp_min(1e-30)).max())
            cross = (compare((got[0][:, L:],), (ref[0][:, L:],))[1]
                     if got[0].shape[1] > L else 0.0)
            f32 = cases[name][2]()[0]
            vs32 = compare((got[0],), (f32,))[1]
            ok = (rel <= PROFILE_RTOL and cross <= FFT_TOL
                  and vs32 <= BF16_PROFILE_TOL
                  and bool(torch.isfinite(got[0]).all()))
            print(f"(n) {name}: counts exact, power rel {rel:.3e}, cross "
                  f"{cross:.3e} of the peak vs plain; {vs32:.3e} of the peak "
                  f"vs the float32 kernel on float32 planes "
                  f"({'ok' if ok else 'FAIL'})", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees")
        else:
            err = check_bf16_planes(name, got, ref)
        del got, ref
        kern_t, plain_t, f32_t = timed[name]
        ms, plain_ms, f32_ms = (cuda_ms(f, reps=10)
                                for f in (kern_t, plain_t, f32_t))
        results[name] = result(err, ms, plain_ms, costs[name])
        print(f"(n) {name}: {ms:.4f} ms kernel, {f32_ms:.4f} ms its float32 "
              f"twin, {plain_ms:.4f} ms plain, bound "
              f"{results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}) [{gpu}]", flush=True)
        if name in PARENT_MS:
            print(f"(n) {parent_note(name, ms)}, {check_form(name, y16)} "
                  f"form [{gpu}]", flush=True)
    return results


def drive_bf16_ops(pipe, gpu):
    """Phase (n), the path: ``dedisperse_fold_split`` and
    ``dedisperse_fold_split_packed`` with ``inter_dtype='bfloat16'``, power
    and Stokes, float32 and bf16 chirps, at the flagship window, counted
    (every bf16 kernel must launch), against the plain bf16 path and the
    float32 op (counts exact, profiles within 1e-3 of the peak), then each
    op timed in turns: float32, bf16, bf16 with a bf16 chirp.  Returns the
    launch counts."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    bf = torch.bfloat16
    T = pipe.global_block
    words, planes, edges, scale, chirp, fold = flagship_inputs(pipe)
    chirp16 = tuple(c.to(bf) for c in chirp)
    ops = {"split": (dd.dedisperse_fold_split, planes),
           "split_packed": (dd.dedisperse_fold_split_packed, words)}

    def call(op, stokes, inter, c):
        fn, x = ops[op]
        kw = dict(n_phase=pipe.n_phase, pad_start=pipe.pad_start, n_valid=T,
                  stokes=stokes, inter_dtype=inter)
        return lambda: fn(*x, *edges, *c, fold, scale, **kw)

    runs = [(op, stokes, c) for op in ops for stokes in (False, True)
            for c in ("float32", "bfloat16")]
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    got = {r: call(r[0], r[1], "bfloat16",
                   chirp16 if r[2] == "bfloat16" else chirp)() for r in runs}
    torch.cuda.synchronize()
    launches = dict(dd.launch_counts)
    print(f"(n) launches of the bf16 ops: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    missing = [k for k in BF16_KERNELS if launches[k] <= 0]
    other = [k for k, v in launches.items() if v and k not in BF16_KERNELS]
    if missing or other:
        raise AssertionError(f"bf16 ops: not launched {missing}, float32 "
                             f"kernels launched {other}")
    for (op, stokes, c), (prof, cnt) in got.items():
        chirp_in = chirp16 if c == "bfloat16" else chirp
        rprof, rcnt = plain(call(op, stokes, "bfloat16", chirp_in))()
        fprof, fcnt = call(op, stokes, "float32", chirp)()
        torch.cuda.synchronize()
        vs_plain = compare((prof,), (rprof,))[1]
        vs_f32 = compare((prof,), (fprof,))[1]
        tag = f"{op} {'stokes' if stokes else 'power'}, {c} chirp"
        print(f"(n) {tag}: counts {int(cnt.sum())} exact; profile "
              f"{vs_plain:.3e} of the peak vs plain bf16, {vs_f32:.3e} vs "
              f"the float32 op [{gpu}]", flush=True)
        if (not torch.equal(cnt, rcnt) or not torch.equal(cnt, fcnt)
                or int(cnt.sum()) != pipe._n_fft
                or vs_plain > BF16_PROFILE_TOL or vs_f32 > BF16_PROFILE_TOL
                or not bool(torch.isfinite(prof).all())):
            raise AssertionError(f"bf16 {tag} disagrees")
    del got
    samples = T * pipe.n_chan * pipe.n_pol
    for op in ops:
        calls = {"float32": call(op, False, "float32", chirp),
                 "bf16": call(op, False, "bfloat16", chirp),
                 "bf16 + bf16 chirp": call(op, False, "bfloat16", chirp16)}
        best = {}
        for key in ("float32", "bf16", "bf16 + bf16 chirp",
                    "bf16 + bf16 chirp", "bf16", "float32"):
            best[key] = min(best.get(key, np.inf), cuda_ms(calls[key]))
        print(f"(n) {op} per window: " + ", ".join(
            f"{k} {v:.4f} ms ({samples / v * 1e3:.4e} samples/s)"
            for k, v in best.items()) + f" [{gpu}]", flush=True)
    return launches


C1_SAMPLES, C1_BLOCK = 1 << 22, 1 << 23   # eager source; compiled block


def config1_chain(dev, n):
    """BASELINE config 1 (``tools/bench_full.py`` config1): noise (seed 7,
    16 MHz, frames of 2^16) -> Channelize(256) -> Square -> Integrate(16),
    ``n`` source samples."""
    from baseband_tasks_tpu_torch import (Channelize, Integrate,
                                          NoiseGenerator, Square, Time)
    from baseband_tasks_tpu_torch import units as u
    src = NoiseGenerator(shape=(n,), start_time=Time.from_mjd(58000.0),
                         sample_rate=16 * u.MHz, samples_per_frame=1 << 16,
                         seed=7, device=dev)
    return Integrate(Square(Channelize(src, 256)), 16)


def host_s(fn, turns=2):
    """Best host time of ``fn`` over ``turns`` calls, each synchronised."""
    best = np.inf
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def drive_config1(dev, gpu):
    """Phase (o), config 1: read eagerly on the card (2^22 samples, 1024
    bins), then compiled through ``run_reduced`` under
    ``fft_maker.set('pallas')`` with blocks of lcm(block_samples, 2^23)
    samples (the bench's block), on the same noise extended to two blocks;
    compiled against eager (rtol 1e-5, counts exact), both timed."""
    from baseband_tasks_tpu_torch import fft_maker
    from baseband_tasks_tpu_torch.models.compiled import CompiledPipeline
    eager = config1_chain(dev, C1_SAMPLES)
    eager.seek(0)
    eager.read(64)                            # warm the frame caches
    out = {}

    def read_all():
        eager.seek(0)
        out["ref"] = eager.read()
    eager_s = host_s(read_all, turns=1)
    ref = out["ref"]
    with fft_maker.set("pallas"):
        tail = config1_chain(dev, 2 * C1_BLOCK)
        block = int(np.lcm(CompiledPipeline(tail).block_samples, C1_BLOCK))
        cp = CompiledPipeline(tail, block_samples=block)
    blocks = cp.read_source_blocks(2)
    avg, cnt = cp.run_reduced(blocks)
    torch.cuda.synchronize()
    n = ref.shape[0]
    rel = float(((avg[:n] - ref).abs() / ref.abs()).max())
    print(f"(o) config 1: eager {tuple(ref.shape)} bins, compiled "
          f"{tuple(avg.shape)} from 2 blocks of {block} samples "
          f"({blocks[0].numel() * blocks.element_size() / 2 ** 20:.0f} MB "
          f"each); compiled vs eager max rel {rel:.3e}, counts "
          f"{sorted(set(cnt.tolist()))} [{gpu}]", flush=True)
    if (rel > 1e-5 or not bool((cnt == 16).all())
            or not bool(torch.isfinite(avg).all())
            or tuple(avg.shape) != (2 * C1_BLOCK // 4096, 256)):
        raise AssertionError("config 1: compiled disagrees with eager")
    run = cp.run_fn(2)
    dt = host_s(lambda: run(blocks), turns=5)
    print(f"(o) config 1 compiled: {1e3 * dt / 2:.3f} ms per {block}-sample "
          f"block, {2 * block / dt:.4e} source samples/s; eager read "
          f"{1e3 * eager_s:.1f} ms for {C1_SAMPLES} samples "
          f"({1e3 * eager_s * block / C1_SAMPLES:.1f} ms per block), "
          f"{C1_SAMPLES / eager_s:.4e} source samples/s [{gpu}]", flush=True)

    def eager_bins():
        eager.seek(0)
        eager.read(64)
    for name, fn, per in (("compiled, per block", lambda: run(blocks), 2),
                          ("eager, per 64 bins", eager_bins, 1)):
        print_profile(f"(o) config 1 {name}", fn, per, gpu)


def print_profile(tag, fn, per, gpu):
    """One profiled call of ``fn``: wall and device-busy ms over ``per``,
    the busy share, and the kernels taking the most device time."""
    wall, busy, rows = device_profile(fn)
    top = ", ".join(f"{name[:48]} x{n} {us / 1e3 / per:.3f}"
                    for us, n, name in rows[:4])
    print(f"{tag}: {wall / per:.3f} ms wall, {busy / per:.3f} ms device "
          f"busy ({busy / wall:.2f} of the wall); {top} [{gpu}]", flush=True)


MF_BLOCK, MF_BLOCKS, MF_CHAN, MF_PHASE = 1 << 14, 16, 128, 64


def masked_fold_chain(dev, blocks, masked):
    """``tools/bench_full.py`` ``_fold_chain_rate``: float32 (2^14, 128)
    blocks -> Square -> Fold(64, masked, average=False) stepping one block,
    the phase of a 12345.6 Hz pulsar; the source serves ``blocks``."""
    from baseband_tasks_tpu_torch import Fold, Square, StreamGenerator, Time
    from baseband_tasks_tpu_torch import units as u
    from baseband_tasks_tpu_torch.models.compiled import CompiledPipeline
    t0 = Time.from_mjd(58000.0)
    src = StreamGenerator(lambda sh: blocks[sh.tell() // MF_BLOCK],
                          shape=(MF_BLOCKS * MF_BLOCK, MF_CHAN), start_time=t0,
                          sample_rate=1 * u.MHz, samples_per_frame=MF_BLOCK,
                          dtype=np.float32, device=dev)
    phase = (lambda t: u.Quantity((t - t0).sec * 12345.6, u.cycle))
    tail = Fold(Square(src), MF_PHASE, phase,
                u.Quantity(MF_BLOCK / 1e6, u.s), samples_per_frame=1,
                masked=masked, average=False)
    return tail, CompiledPipeline(tail, block_samples=MF_BLOCK)


def drive_masked_fold(dev, gpu):
    """Phase (o), the masked fold: 16 float32 (2^14, 128) blocks on the
    card through ``run_reduced``, masked on blocks with NaN cells (block 3
    of channel 5 fully flagged, ~1 % of the samples scattered) and
    unmasked on clean ones; each against the eager Fold (counts and NaN
    cells exact, averages rtol 1e-5); the flagged samples drop out of
    their cells only; masked and unmasked timed in turns."""
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    clean = torch.randn((MF_BLOCKS, MF_BLOCK, MF_CHAN), generator=g,
                        device=dev)
    flagged = clean.clone()
    flagged[torch.rand(flagged.shape, generator=g, device=dev) < 0.01] = \
        float("nan")
    flagged[3, :, 5] = float("nan")
    cps = {}
    for masked, blocks in ((False, clean), (True, flagged)):
        tail, cp = masked_fold_chain(dev, blocks, masked)
        avg, cnt = cp.run_reduced(blocks)
        tail.seek(0)
        eager = tail.read()
        torch.cuda.synchronize()
        want = eager.data / eager.count.clamp_min(1)
        nan_cells = eager.count == 0
        want = torch.where(nan_cells, torch.full_like(want, float("nan")),
                           want)
        fin = ~nan_cells
        rel = float(((avg[fin] - want[fin]).abs() / want[fin].abs()).max())
        # unmasked counts are per (bin, phase), the eager read's broadcast
        cells = cnt if masked else cnt[..., None].expand(eager.count.shape)
        ok = (torch.equal(cells, eager.count)
              and torch.equal(avg.isnan(), nan_cells) and rel <= 1e-5)
        if masked:
            finite = torch.isfinite(blocks).sum(dim=1)       # (block, chan)
            ok = (ok and torch.equal(cnt.sum(dim=1), finite)
                  and bool(avg[3, :, 5].isnan().all())
                  and int(nan_cells.sum()) == MF_PHASE)
        print(f"(o) masked fold, masked={masked}: {tuple(avg.shape)}, counts "
              f"exact, {int(nan_cells.sum())} NaN cells, {int(cells.sum())} "
              f"samples counted of {blocks.numel()}, vs eager rel {rel:.3e} "
              f"({'ok' if ok else 'FAIL'}) [{gpu}]", flush=True)
        if not ok:
            raise AssertionError(f"masked fold (masked={masked}) wrong")
        cps[masked] = (cp.run_fn(MF_BLOCKS), blocks)
    best = {}
    for masked in (False, True, True, False):
        run, blocks = cps[masked]
        best[masked] = min(best.get(masked, np.inf),
                           host_s(lambda: run(blocks), turns=5))
    for masked in (False, True):
        run, blocks = cps[masked]
        print_profile(f"(o) masked fold run, masked={masked}",
                      lambda: run(blocks), 1, gpu)
    n = MF_BLOCKS * MF_BLOCK * MF_CHAN
    print(f"(o) masked fold run of {MF_BLOCKS} blocks: unmasked "
          f"{1e3 * best[False]:.3f} ms ({n / best[False]:.4e} samples/s), "
          f"masked {1e3 * best[True]:.3f} ms ({n / best[True]:.4e} "
          f"samples/s), overhead {best[True] / best[False] - 1:.3f} [{gpu}]",
          flush=True)


# -- the slice of joins, resampling and incoherent dispersion: (r)-(t) ------

CORR_N = 1 << 24             # tools/bench_full.py correlator()/beamform():
CORR_BLOCK = 1 << 21         # 16 MHz stations of 2^24 samples in 8 blocks
CORR_CHAN = 256
CORR_AVG = 256
CORR_EAGER_BLOCKS = 2        # compiled blocks held against the eager stream
# (s): config 2's source, per-channel delays, the LO at its centre; the
# 129-tap response's 128-sample pad rounds up to one N2 = 512 row block
RESAMPLE_SPF = 261632
RESAMPLE_PAD = 64
# (t): config 1's detected filterbank at config 2's DM
INCOH_SAMPLES = 1 << 23
INCOH_SPF = 4096


def fx_chain(dev, model):
    """``tools/bench_full.py`` correlator() or beamform() in the port: 16
    MHz complex noise stations (seeds 3, 4, ...), 256 channels, 'phase'
    delays in frames of 2^21; the correlator 2 stations at tau = 37.25
    samples and n_avg 256, the beamformer 4 stations at (11.25 + 7k)
    samples, coherent."""
    from baseband_tasks_tpu_torch import NoiseGenerator, Time, units as u
    from baseband_tasks_tpu_torch.models import fx_correlate, tied_array_beam
    rate = 16 * u.MHz
    n_st = 2 if model == "correlator" else 4
    # a frame more than the 8 blocks: the delayed stations' blocks are
    # read from their alignment offsets
    streams = [NoiseGenerator(shape=(CORR_N + (1 << 16),),
                              start_time=Time.from_mjd(58000.0),
                              sample_rate=rate, samples_per_frame=1 << 16,
                              seed=3 + k, device=dev) for k in range(n_st)]
    if model == "correlator":
        return fx_correlate(streams, CORR_CHAN, CORR_AVG,
                            delays=[None, 37.25 / rate], method="phase",
                            samples_per_frame=CORR_BLOCK)
    delays = [None] + [(11.25 + 7 * k) / rate for k in range(1, n_st)]
    return tied_array_beam(streams, CORR_CHAN, delays=delays,
                           method="phase", samples_per_frame=CORR_BLOCK)


def drive_fx(dev, gpu):
    """Phase (r): the FX correlator and the tied-array beamformer compiled
    at full width, 8 blocks of 2^21 samples a station through ``run_fn``
    (one block tensor a station; the correlator's Integrate absorbed),
    the first two blocks against the eager stream (``_compare_eager``'s
    rtol 1e-3, atol 2e-3; the correlator on its full visibilities), the
    autocorrelations against the noise's 2 x 256 per channel, then timed
    (ms per block, station samples/s) and profiled.  No kernel of the
    port runs here: the F stage is a 256-point torch.fft, and the
    correlator's 3 baselines x 256 channels are below
    ``ops.xcorr.MIN_BASELINE_CELLS``, so its X stage keeps the products
    and their ``index_add_``."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    n_blocks = CORR_N // CORR_BLOCK
    for model in ("correlator", "beamform"):
        tail = fx_chain(dev, model)
        cp = CompiledPipeline(tail, block_samples=CORR_BLOCK)
        n_st = len(cp.sources)
        blocks = cp.read_source_blocks(n_blocks)
        torch.cuda.synchronize()
        run = cp.run_fn(n_blocks)
        dd.reset_launch_counts()
        out = run(blocks)
        torch.cuda.synchronize()
        if any(dd.launch_counts.values()) or cp.x_form != "products":
            raise AssertionError(f"{model}: x_form {cp.x_form!r}, launched "
                                 f"{dd.launch_counts}")
        print(f"(r) {model}: {n_st} stations, block {cp.block_samples}, "
              f"tail block {cp.tail_block}, delay {cp.delay}, warmup "
              f"{cp.warmup}, source offsets {cp.source_offsets}", flush=True)
        tail.seek(0)
        if model == "correlator":
            sums, counts = out
            vis = sums / counts.reshape(-1, 1, 1).clamp_min(1)
            n = CORR_EAGER_BLOCKS * cp.tail_block // CORR_AVG
            full = counts[:n] == CORR_AVG
            eager = tail.read(n)
            got, ref = vis[:n][full], eager[full]
            autos = vis[counts == CORR_AVG][:, [0, 2]].real
            level = float(autos.mean()) / (2 * CORR_CHAN)
            cross = float((vis[counts == CORR_AVG][:, 1].abs()
                           / autos.prod(dim=1).sqrt()).mean())
            shape_ok = (tuple(vis.shape) == (n_blocks * cp.tail_block
                                             // CORR_AVG, 3, CORR_CHAN)
                        and int(full.sum()) >= n - 1
                        and abs(level - 1) < 0.01 and cross < 0.1)
            print(f"(r) correlator: {tuple(vis.shape)} visibilities, counts "
                  f"{sorted(set(counts.tolist()))}; autos {level:.4f} of 2 x "
                  f"{CORR_CHAN}, mean |coherence| {cross:.4f} (independent "
                  f"stations)", flush=True)
        else:
            d, w = int(cp.delay), cp.warmup
            n = CORR_EAGER_BLOCKS * cp.tail_block
            eager = tail.read(n - d)
            got, ref = out[w:n], eager[w - d:]
            level = float((out.abs() ** 2).mean()) / (2 * CORR_CHAN / n_st)
            shape_ok = (tuple(out.shape) == (n_blocks * cp.tail_block,
                                             CORR_CHAN)
                        and abs(level - 1) < 0.01)
            print(f"(r) beamform: {tuple(out.shape)} beam spectra, power "
                  f"{level:.4f} of 2 x {CORR_CHAN} / {n_st} (independent "
                  f"stations)", flush=True)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        ratio = float((diff / (EAGER_ATOL + EAGER_RTOL * ref.abs())).max())
        finite = bool(torch.isfinite(torch.view_as_real(
            vis if model == "correlator" else out)).all())
        print(f"(r) {model}: compiled vs eager over {CORR_EAGER_BLOCKS} "
              f"blocks ({got.shape[0]} rows): max |d| {float(diff.max()):.3e}"
              f", {ratio:.3e} of the rtol/atol bound [{gpu}]", flush=True)
        if ratio > 1.0 or not finite or not shape_ok:
            raise AssertionError(f"{model}: output wrong")
        del out, got, ref, eager
        dt = host_s(lambda: run(blocks), turns=3)
        samples = n_st * n_blocks * cp.block_samples
        print(f"(r) {model} compiled: {1e3 * dt / n_blocks:.3f} ms per "
              f"{cp.block_samples}-sample block, {samples / dt:.4e} station "
              f"samples/s [{gpu}]", flush=True)
        print_profile(f"(r) {model}, per block", lambda: run(blocks),
                      n_blocks, gpu)
        del blocks, run, cp, tail
        torch.cuda.empty_cache()


def resample_node(dev):
    """Phase (s)'s path: ShiftAndResample(engine='pallas') of config 2's
    source by per-channel delays of linspace(0.1, 0.9, 128) samples, LO
    1400 MHz, pad 64, frames of 261,632 samples (a 2^18 window)."""
    from baseband_tasks_tpu_torch import ShiftAndResample, units as u
    return ShiftAndResample(config2_source(dev), np.linspace(0.1, 0.9, 128),
                            lo=1400 * u.MHz, pad=RESAMPLE_PAD,
                            samples_per_frame=RESAMPLE_SPF, engine="pallas")


def check_resample_geometry(node):
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    got = (node.engine, node._padded_samples_per_frame, node.pad_start,
           node.pad_end, node.samples_per_frame, node.response.shape[0])
    forms = [check_k1_form("k1_window"), check_k1_form("k1_stream"),
             dd.k2_form("k2", 512, 128)]
    print(f"(s) resample: engine, window, pads, frame, taps {got}; K1 "
          f"forms {forms[:2]}, K2 {forms[2]}", flush=True)
    if got != ("pallas", 1 << 18, 448, 64, RESAMPLE_SPF, 129) \
            or forms[2] != "register":
        raise AssertionError(f"resample: geometry {got}, K2 {forms[2]}")


def drive_resample(dev, gpu):
    """Phase (s): the resample path eagerly (k1_window, k2, k3_trim a
    frame) and compiled (k1_stream, k2, k3_trim a block through
    ``planes_step``), each with its launches counted, against the same
    path on the plain versions (1e-4 of the peak), the compiled blocks
    against the eager frames (the response fits its pads: equal to
    roundoff), then timed in turns.  Returns the launch counts of the
    two runs."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    kern, ref = resample_node(dev), resample_node(dev)
    check_resample_geometry(kern)
    launches = {}

    def counted(name, fn, want):
        dd.reset_launch_counts()
        out = fn()
        counts = dict(dd.launch_counts)
        print(f"(s) resample {name}: launches {counts}", flush=True)
        bad = {k: counts[k] for k in counts if counts[k] != want.get(k, 0)}
        if bad:
            raise AssertionError(f"resample {name}: launches {bad}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out

    got = counted("eager", lambda: read_frames(kern, None, 0, N_FRAMES),
                  {k: N_FRAMES for k in ("k1_window", "k2", "k3_trim")})
    want = plain(read_frames)(ref, None, 0, N_FRAMES)
    err, rel = compare((got.real, got.imag), (want.real, want.imag))
    print(f"(s) resample eager: {tuple(got.shape)}, kernels vs plain max abs "
          f"err {err:.3e}, {rel:.3e} of the peak [{gpu}]", flush=True)
    if rel > FFT_TOL or tuple(got.shape) != (N_FRAMES * RESAMPLE_SPF, 128):
        raise AssertionError("resample eager: output wrong")
    del want
    kcp, pcp = CompiledPipeline(kern), CompiledPipeline(ref)
    blocks = kcp.read_source_blocks(N_FRAMES)
    outs = counted("compiled", lambda: run_planes(kcp, blocks,
                                                  [None] * N_FRAMES),
                   {k: N_FRAMES for k in ("k1_stream", "k2", "k3_trim")})
    comp = joined(outs)
    refs = joined(plain(run_planes)(pcp, blocks, [None] * N_FRAMES))
    err, rel = compare((comp.real, comp.imag), (refs.real, refs.imag))
    d, w = int(kcp.delay), kcp.warmup
    eerr, erel = compare((comp[w:].real, comp[w:].imag),
                         (got[w - d:comp.shape[0] - d].real,
                          got[w - d:comp.shape[0] - d].imag))
    print(f"(s) resample compiled: block {kcp.block_samples}, delay {d}, "
          f"warmup {w}; kernels vs plain {rel:.3e} of the peak, vs the eager "
          f"frames past warmup {erel:.3e} [{gpu}]", flush=True)
    if rel > FFT_TOL or erel > FFT_TOL:
        raise AssertionError("resample compiled: output wrong")
    del got, comp, refs, outs
    best = {}
    runs = {"kernels": (kern, read_frames), "plain": (ref, plain(read_frames))}
    for frame, key in enumerate(("plain", "kernels", "kernels", "plain"),
                                start=N_FRAMES):
        node, read = runs[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        read(node, None, frame, 1)
        best[key] = min(best.get(key, np.inf), time.perf_counter() - t0)
    for key, dt in best.items():
        print(f"(s) resample eager frame {key}: {1e3 * dt:.3f} ms/frame, "
              f"{RESAMPLE_SPF * 128 / dt:.4e} samples/s (source read "
              f"included) [{gpu}]", flush=True)
    del blocks
    time_compiled("resample", kcp, pcp, gpu, phase="(s)")
    return launches


def incoherent_chain(dev):
    """Phase (t)'s path: config 1's source (16 MHz noise, seed 7, frames
    of 2^16), labelled 1400 MHz (sideband +1), -> Channelize(256) ->
    Square -> DedisperseSamples(DM 29.7) in frames of 4096 spectra."""
    from baseband_tasks_tpu_torch import (Channelize, DedisperseSamples,
                                          NoiseGenerator, SetAttribute,
                                          Square, Time, units as u)
    src = SetAttribute(NoiseGenerator(
        shape=(INCOH_SAMPLES,), start_time=Time.from_mjd(58000.0),
        sample_rate=16 * u.MHz, samples_per_frame=1 << 16, seed=7,
        device=dev), frequency=1400 * u.MHz, sideband=1)
    return DedisperseSamples(Square(Channelize(src, 256)), 29.7,
                             samples_per_frame=INCOH_SPF)


def drive_incoherent(dev, gpu):
    """Phase (t): DedisperseSamples eagerly on the card, three frames read
    against the per-channel shift applied to the detected filterbank read
    alone (1e-6 of the peak), then ms per frame."""
    node = incoherent_chain(dev)
    n = 3 * INCOH_SPF
    got = read_frames(node, None, 0, 3)
    det = node.ih
    det.seek(0)
    raw = det.read()
    idx = (torch.arange(n, device=dev)[:, None]
           + torch.as_tensor(node._rel_index_host, device=dev))
    want = torch.gather(raw, 0, idx)
    err, rel = compare((got,), (want,))
    shifts = node.pad_start - node._rel_index_host
    print(f"(t) DedisperseSamples: {tuple(got.shape)} from {tuple(raw.shape)}"
          f" spectra, pads ({node.pad_start}, {node.pad_end}), shifts "
          f"{int(shifts.min())}..{int(shifts.max())}; vs the shifted "
          f"filterbank {rel:.3e} of the peak [{gpu}]", flush=True)
    if rel > 1e-6 or tuple(got.shape) != (n, 256):
        raise AssertionError("DedisperseSamples: output wrong")
    best = np.inf
    for frame in range(3, 6):
        best = min(best, host_s(lambda: read_frames(node, None, frame, 1), 1))
    print(f"(t) DedisperseSamples eager: {1e3 * best:.3f} ms/frame of "
          f"{INCOH_SPF} spectra x 256 channels, "
          f"{INCOH_SPF * 256 / best:.4e} samples/s (channelize and square "
          f"included) [{gpu}]", flush=True)


# -- the mesh: phases (p) and (q) ---------------------------------------------

N_SHARDS = 4                 # virtual shards of the one card


def virtual_mesh(dev, time, chan):
    """A (time, chan) mesh whose every shard lives on ``dev``."""
    from baseband_tasks_tpu_torch.parallel import make_mesh
    return make_mesh(time=time, chan=chan, devices=[dev] * (time * chan))


def same_edges(got, ref):
    """Every (front, end) buffer bit-identical, on the same device (the
    buffers of a list of shards, or of an object grid)."""
    def flat(bufs):
        return list(bufs.flat) if isinstance(bufs, np.ndarray) else bufs
    pairs = [p for k in (0, 1) for p in zip(flat(got[k]), flat(ref[k]))]
    return all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in pairs)


def check_halo_kernel(dev, gpu):
    """Phase (p): halo_remote against halo_edges_remote_ref (the copies
    of halo='ppermute') on four virtual shards of the card, at the
    flagship's shapes: its float planes (253,952 x 128, one plane a call
    on the float run_fn path), step_fn's (T, 64, 2, 2) float32 pairs and
    complex64 (T, 64, 2), non-periodic and periodic, bit-identical; then
    both timed on the planes beside the bound."""
    from baseband_tasks_tpu_torch.parallel import halo_remote as hr
    host = flagship_on_host()
    ps, pe, T = host.pad_start, host.pad_end, host.block_samples
    C, P = host.n_chan, host.n_pol
    g = torch.Generator(device=dev)
    g.manual_seed(70)
    cases = {
        "planes": [torch.randn((T, C * P), generator=g, device=dev)
                   for _ in range(N_SHARDS)],
        "pairs": [torch.randn((T, C, P, 2), generator=g, device=dev)
                  for _ in range(N_SHARDS)],
        "complex64": [torch.randn((T, C, P), generator=g, device=dev,
                                  dtype=torch.complex64)
                      for _ in range(N_SHARDS)],
    }
    for name, blocks in cases.items():
        for periodic in (False, True):
            got = hr.halo_edges_remote(blocks, ps, pe, periodic)
            ref = hr.halo_edges_remote_ref(blocks, ps, pe, periodic)
            torch.cuda.synchronize()
            ok = same_edges(got, ref)
            print(f"(p) halo_remote {name} {tuple(blocks[0].shape)} x "
                  f"{N_SHARDS}, pads ({ps}, {pe}), periodic={periodic}: "
                  f"{'bit-identical' if ok else 'DIFFERS'} to the plain "
                  f"copies", flush=True)
            if not ok:
                raise AssertionError(f"halo_remote {name} differs")
    out = {}
    for name in ("planes", "pairs"):
        blocks = cases[name]
        front, end = hr.halo_edges_remote(blocks, ps, pe)
        fns = {"kernel": lambda: hr.halo_edges_remote(blocks, ps, pe),
               "plain": lambda: hr.halo_edges_remote_ref(blocks, ps, pe)}
        # a call is a few microseconds of device work behind tens of
        # microseconds of host work: the device time per call (profiled)
        # is the kernel's, the back-to-back call time the caller's
        dev_ms = {k: device_ms(f) for k, f in fns.items()}
        call_ms = {k: cuda_ms(f) for k, f in fns.items()}
        # the bytes it must move: the interior edges read once, every
        # edge (the zero ends too) written once
        out[name] = result(0.0, dev_ms["kernel"], dev_ms["plain"],
                           (front[1:] + end[:-1], front + end, 0))
        print(f"(p) halo_remote {name}: device {dev_ms['kernel']:.4f} ms a "
              f"call kernel, {dev_ms['plain']:.4f} ms plain; a call "
              f"back to back {call_ms['kernel']:.4f} ms kernel, "
              f"{call_ms['plain']:.4f} ms plain; bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}) "
              f"[{gpu}]", flush=True)
    del cases
    return {"halo_remote": out["planes"]}


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: the device time of every kernel
    and copy it launches, under ``torch.profiler`` over ``reps`` calls,
    per call (the host's gaps between launches left out)."""
    fn()
    _, busy, _ = device_profile(lambda: [fn() for _ in range(reps)])
    return busy / reps


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def best_ms(runs, order, per):
    """Best host ms of each run over ``order`` (its keys in turns), each
    call synchronised, divided by ``per``."""
    best = {}
    for key in order:
        best[key] = min(best.get(key, np.inf), host_s(runs[key], turns=1))
    return {k: 1e3 * v / per for k, v in best.items()}


def drive_sharded(dev, gpu):
    """Phase (q): the sharded flagship at full width on virtual meshes of
    the card.  ``run_fn(8, ingest_bits=8)`` on (4, 1) and (2, 2) against
    the plain versions; the halo kernel's path (float ``run_fn(2)`` with
    halo='remote', its launches counted) and ``step_fn`` on both paths,
    'remote' against 'ppermute'; a dm=0 step against the closed-form
    numpy fold; (4, 2) against (4, 1); ``search_sharded`` and
    ``snr_sharded`` on four shards against the unsharded calls; then the
    sharded step and the two halo backends timed.  Returns the launch
    counts of the halo kernel's path, and the (4, 1) packed run's profile
    and counts (on the host) and ms a step, for phase (x)."""
    from baseband_tasks_tpu_torch import (FastFoldingSearch,
                                          WidebandPulsarPipeline, units as u)
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.parallel import Mesh
    meshes = {"4x1": virtual_mesh(dev, 4, 1), "2x2": virtual_mesh(dev, 2, 2)}
    refs = {}
    for name, mesh in meshes.items():
        pipe = flagship(None, mesh=mesh)
        run = pipe.run_fn(N_ITER, ingest_bits=8)
        dd.reset_launch_counts()
        got = run(seed=0)
        torch.cuda.synchronize()
        counts = nonzero(dd.launch_counts)
        want = {k: N_ITER * N_SHARDS for k in ("k1_packed", "k2", "k3_fold")}
        print(f"(q) run_fn({N_ITER}, ingest_bits=8) on {name} (shard L "
              f"{pipe._c_local * pipe.n_pol}): launches {counts}",
              flush=True)
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, want {want}")
        ref = plain(run)(seed=0)
        total = int(got[1].sum())
        print(f"(q) {name}: counts sum {total} (want "
              f"{N_ITER * pipe.global_block})", flush=True)
        if total != N_ITER * pipe.global_block:
            raise AssertionError(f"{name}: counts wrong")
        check_profile(f"run_fn on {name}", got, ref, False, gpu, "(q)")
        if name == "4x1":
            refs["run"] = tuple(t.cpu() for t in got)
        del pipe, run, got, ref
        torch.cuda.empty_cache()

    # the halo kernel's main path: float run_fn(2) with halo='remote'
    pipes = {h: flagship(None, mesh=meshes["4x1"], halo=h)
             for h in ("ppermute", "remote")}
    runs = {h: p.run_fn(2) for h, p in pipes.items()}
    runs["remote"](seed=0)               # the payload, made once per seed
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    got = runs["remote"](seed=0)
    torch.cuda.synchronize()
    launches = dict(dd.launch_counts)
    want = {"k1_float": 2 * N_SHARDS, "k2": 2 * N_SHARDS,
            "k3_fold": 2 * N_SHARDS, "halo_remote": 2 * 2}
    print(f"(q) run_fn(2) halo='remote' on 4x1: launches "
          f"{nonzero(launches)}", flush=True)
    if nonzero(launches) != want:
        raise AssertionError(f"run_fn(2) remote: launches, want {want}")
    ref = runs["ppermute"](seed=0)
    # the edges themselves bit for bit; the profiles to the fold's
    # run-dependent atomic order
    shape = (pipes["remote"].global_block, 64, 2)
    grid = [shard_grid(b, meshes["4x1"]) for b in
            pipes["remote"]._payload(0, shape, None)]
    for plane in grid:
        if not same_edges(pipes["remote"]._halo_edges(plane),
                          pipes["ppermute"]._halo_edges(plane)):
            raise AssertionError("remote edges differ from ppermute")
    print("(q) run_fn(2) 'remote' edges bit-identical to 'ppermute'",
          flush=True)
    check_profile("run_fn(2) 'remote' vs 'ppermute'", got, ref, False, gpu,
                  "(q)")
    del grid, got, ref

    for kernels in (True, False):
        step = {h: flagship(None, mesh=meshes["4x1"], halo=h,
                            use_kernels=kernels)
                for h in ("ppermute", "remote")}
        T = step["remote"].global_block
        (xf,) = randn(dev, (T, 64, 2, 2), 72, count=1)
        row = step["remote"].fold_model.foldv(3 * T, T)
        dd.reset_launch_counts()
        a = step["remote"].step_fn()(xf, row)
        torch.cuda.synchronize()
        halo = dd.launch_counts["halo_remote"]
        b = step["ppermute"].step_fn()(xf, row)
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        print(f"(q) step_fn ({'kernel' if kernels else 'plain'} path) on "
              f"4x1: halo_remote launches {halo}; 'remote' "
              f"{'bit-identical' if same else 'DIFFERS'} to 'ppermute'; "
              f"counts {int(a[1].sum())} (want {T})", flush=True)
        if halo != 1 or not same or int(a[1].sum()) != T:
            raise AssertionError("step_fn remote vs ppermute")
        if kernels:
            check_profile("step_fn kernels", a,
                          plain(step["remote"].step_fn())(xf, row), False,
                          gpu, "(q)")
        del step, xf, a, b
        torch.cuda.empty_cache()

    # dm = 0: a unit chirp, so the profile is a direct fold of |x|^2
    zero = WidebandPulsarPipeline(
        n_chan=64, n_pol=2, dm=0.0, freq_center=1400 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(16384, 3), n_phase=64,
        block_samples=1 << 15, mesh=meshes["2x2"], use_kernels=True)
    T = zero.global_block
    (xf,) = randn(dev, (T, 64, 2, 2), 73, count=1)
    prof, cnt = zero.step_fn()(xf, 0)
    x = xf.double().cpu().numpy()
    power = x[..., 0] ** 2 + x[..., 1] ** 2
    bins = (np.arange(T) * 3 % 16384) * 64 // 16384
    expect = np.stack([power[bins == k].sum(0) for k in range(64)])
    err = np.abs(prof.cpu().numpy() - expect)
    ratio = float((err / (0.05 + 2e-3 * np.abs(expect))).max())
    exact = np.array_equal(cnt.cpu().numpy(), np.bincount(bins, minlength=64))
    print(f"(q) dm=0 step_fn on 2x2 ({T} samples): {ratio:.3f} of the "
          f"closed-form rtol 2e-3 / atol 0.05 bound, counts "
          f"{'exact' if exact else 'WRONG'}", flush=True)
    if ratio > 1.0 or not exact:
        raise AssertionError("dm=0 sharded step disagrees with numpy")
    del zero, xf, x, power

    # the chan axis needs no communication: (4, 2) against (4, 1)
    wide = flagship(None, mesh=virtual_mesh(dev, 4, 2))
    T = wide.global_block
    (xf,) = randn(dev, (T, 64, 2, 2), 74, count=1)
    row = wide.fold_model.foldv(0, T)
    a = wide.step_fn()(xf, row)
    b = flagship(None, mesh=meshes["4x1"]).step_fn()(xf, row)
    ratio = float(((a[0] - b[0]).abs() / (1e-3 + 1e-6 * b[0].abs())).max())
    same = torch.equal(a[1], b[1])
    print(f"(q) step_fn 4x2 vs 4x1: {ratio:.3f} of the rtol 1e-6 / atol "
          f"1e-3 bound, counts {'equal' if same else 'DIFFER'}", flush=True)
    if ratio > 1.0 or not same:
        raise AssertionError("chan resharding changed the profile")
    del wide, xf, a, b
    torch.cuda.empty_cache()

    # the searches' banks and batches over four shards
    x = search_series(dev)
    zmesh = Mesh([dev] * N_SHARDS, ("z",))
    for engine, kernel in (("pallas", "accel_corr"), ("mx", "bank_power")):
        s = accel_search(dev, engine)
        ref = s.search(x)
        s.search_sharded(x, zmesh)            # builds the shards' banks
        torch.cuda.synchronize()
        dd.reset_launch_counts()
        got = s.search_sharded(x, zmesh)
        torch.cuda.synchronize()
        counts = nonzero(dd.launch_counts)
        _, rel = compare((got,), (ref,))
        ms = cuda_ms(lambda: s.search_sharded(x, zmesh), reps=3)
        one_ms = cuda_ms(lambda: s.search(x), reps=3)
        print(f"(q) search_sharded '{engine}' over {N_SHARDS} shards: "
              f"launches {counts}, vs search() {rel:.3e} of the peak; "
              f"{ms:.3f} ms against {one_ms:.3f} ms unsharded [{gpu}]",
              flush=True)
        if counts != {kernel: N_SHARDS} or rel > FFT_TOL:
            raise AssertionError(f"search_sharded '{engine}' wrong")
        del s, ref, got
    ffa = FastFoldingSearch(FFA_BASE, SEARCH_N, device=dev)
    rows = torch.stack([x] + randn(dev, (SEARCH_N,), 75, count=3))
    got = ffa.snr_sharded(rows, Mesh([dev] * N_SHARDS, ("batch",)))
    ref = ffa.snr(rows)
    worst = float(((got - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max())
    print(f"(q) snr_sharded of {tuple(rows.shape)} over {N_SHARDS} shards "
          f"vs snr(): {worst:.3f} of the rtol/atol 1e-4 bound", flush=True)
    if worst > 1.0 or got.shape != ref.shape:
        raise AssertionError("snr_sharded disagrees with snr")
    del rows, got, ref, x
    torch.cuda.empty_cache()

    # time: the sharded step against one shard's, and the halo backends
    steps = {"1 shard": flagship(dev).run_fn(N_ITER, ingest_bits=8)}
    steps.update({name: flagship(None, mesh=mesh).run_fn(
        N_ITER, ingest_bits=8) for name, mesh in meshes.items()})
    for run in steps.values():
        run(seed=0)
    ms = best_ms({k: functools.partial(r, seed=0) for k, r in steps.items()},
                 ("1 shard", "4x1", "2x2", "2x2", "4x1", "1 shard"), N_ITER)
    # a step of a (t, c) mesh folds t windows: against t one-shard steps
    ratio = {name: ms[name] / (mesh.shape["time"] * ms["1 shard"])
             for name, mesh in meshes.items()}
    refs["ms"] = ms["4x1"]
    print(f"(q) packed step: 4x1 {ms['4x1']:.3f} ms/step (4 windows, "
          f"{ratio['4x1']:.3f} of 4 one-shard steps), 2x2 {ms['2x2']:.3f} "
          f"(2 windows, {ratio['2x2']:.3f} of 2), one shard "
          f"{ms['1 shard']:.3f} [{gpu}]", flush=True)
    del steps
    floats = {h: p.run_fn(N_ITER) for h, p in pipes.items()}
    for run in floats.values():
        run(seed=0)
    ms = best_ms({k: functools.partial(r, seed=0) for k, r in floats.items()},
                 ("remote", "ppermute", "ppermute", "remote"), N_ITER)
    print(f"(q) float step on 4x1: halo='remote' {ms['remote']:.3f} ms/step, "
          f"'ppermute' {ms['ppermute']:.3f} ms/step [{gpu}]", flush=True)
    # for phase (x4): the one-process float run with halo='remote'
    refs["remote_ms"] = ms["remote"]
    refs["remote"] = tuple(t.cpu() for t in floats["remote"](seed=0))
    print_profile("(q) profiled float step, 4x1, halo='remote'",
                  functools.partial(floats["remote"], seed=0), N_ITER, gpu)
    return launches, refs


def shard_grid(x, mesh):
    from baseband_tasks_tpu_torch.parallel import shard
    return shard(x, mesh, ("time", "chan"))


# -- stored baseband: phase (u), BASELINE config 4 ---------------------------

# tools/bench_full.py config4_packed(): 16 VDIF threads (8 channels x 2
# pols) of 8-bit complex noise at 2^18 Hz, Dedisperse(29.7) -> Square ->
# Integrate(4096), driven by StreamRunner, packed against float ingest
C4_THREADS, C4_RATE, C4_DM, C4_AVG = 16, 1 << 18, 29.7, 4096
C4_CHECK_BLOCKS = 6          # bench_full's n_blocks: the correctness run
C4_TIME_BLOCKS = 48          # ~200 MB of packed payload: the steady state
C4_PROFILE_BLOCKS = 8


def config4_freq(u):
    return (1400 + 0.262144 * (np.arange(C4_THREADS) // 2)) * u.MHz


def config4_block(dev):
    """The compiled block the padded stage pins ('pallas' on the card: a
    2^17 window less its pads), probed as bench_full does, and the file
    frame: the largest power of two dividing it, at most 4096."""
    import warnings
    from baseband_tasks_tpu_torch import (Dedisperse, NoiseGenerator,
                                          SetAttribute, Time, units as u)
    probe = NoiseGenerator(shape=(1 << 20, C4_THREADS),
                           start_time=Time.from_mjd(58000.0),
                           sample_rate=C4_RATE * u.Hz, samples_per_frame=8192,
                           seed=11, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ded = Dedisperse(SetAttribute(probe, frequency=config4_freq(u),
                                      sideband=1), C4_DM,
                         samples_per_frame=1 << 16)
    block = int(ded.samples_per_frame)
    return block, min(4096, block & -block)


def write_config4(path, block, spf, n_blocks):
    """bench_full's file, written by the port's VDIF writer a block at a
    time: rng(11) standard normals x 16 as 8-bit complex."""
    from baseband_tasks_tpu_torch import NoiseGenerator, Time, units as u
    from baseband_tasks_tpu_torch.io import vdif
    template = NoiseGenerator(shape=(n_blocks * block, C4_THREADS),
                              start_time=Time.from_mjd(58000.0),
                              sample_rate=C4_RATE * u.Hz,
                              samples_per_frame=8192, device="cpu")
    rng = np.random.default_rng(11)
    with vdif.open(path, "w", template=template, bps=8,
                   samples_per_frame=spf, nthread=C4_THREADS) as wh:
        for _ in range(n_blocks):
            x = rng.standard_normal((block, C4_THREADS, 2)).astype(
                np.float32) * 16
            wh.write((x[..., 0] + 1j * x[..., 1]).astype(np.complex64))


def config4_chain(path, dev, block, average=True):
    """A VDIF reader on the card -> Dedisperse(29.7) ('auto') -> Square
    -> Integrate(4096): the reader, the Dedisperse node and the tail."""
    from baseband_tasks_tpu_torch import (Dedisperse, Integrate,
                                          SetAttribute, Square, open,
                                          units as u)
    fr = open(path, sample_rate=C4_RATE * u.Hz, device=dev)
    ded = Dedisperse(SetAttribute(fr, frequency=config4_freq(u), sideband=1),
                     C4_DM, samples_per_frame=block)
    return fr, ded, Integrate(Square(ded), C4_AVG, average=average)


def counted_run(name, runner, n_blocks, want):
    """One runner pass with the launches counted from zero; asserts the
    exact counts.  Returns (sums, counts, launches)."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dd.reset_launch_counts()
    sums, counts = runner.run(n_blocks)
    torch.cuda.synchronize()
    launched = {k: v for k, v in dd.launch_counts.items() if v}
    print(f"(u) config 4 {name}: launches {launched}", flush=True)
    if launched != want:
        raise AssertionError(f"config 4 {name}: launches {launched}, "
                             f"expected {want}")
    return sums, counts, launched


def check_config4_kernels(dev, block, gpu):
    """The path's kernels at config 4's shapes (a 2^17 window of 16
    lanes, pads 512/512) against their plain versions, timed: the layer
    times of the step.  Returns {name: ms}."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.ops import fft as ff
    L, pad = C4_THREADS, 512
    n = block + 2 * pad
    n1, n2 = dd.split_n(n)
    x = randn(dev, (n, L), 61)
    c = randn(dev, (2 * pad, L), 62)
    blk = randn(dev, (block, L), 63)
    ph = torch.rand((n2, n1, L), generator=torch.Generator(
        device=dev).manual_seed(64), device=dev) * 6.283
    g = (torch.cos(ph), torch.sin(ph))
    y = ff.k1_window(*x)
    y2 = [t.clone() for t in y]          # K2 works in place: timed on these

    def k2(planes):
        return lambda: dd.stage_b(*[t.clone() for t in planes], *g)
    # (checked call, timed call, planes in + out)
    cases = {
        "k1_window": (lambda: ff.k1_window(*x), lambda: ff.k1_window(*x),
                      4),
        "k1_stream": (lambda: ff.k1_stream(*c, *blk),
                      lambda: ff.k1_stream(*c, *blk), 4),
        "k2": (k2(y), lambda: dd.stage_b(*y2, *g), 6),
        "k3_trim": (lambda: ff.k3_trim(*y, pad_start=pad, pad_end=pad),
                    lambda: ff.k3_trim(*y, pad_start=pad, pad_end=pad),
                    2 + 2 * block / n)}
    times = {}
    for name, (check, timed, planes) in cases.items():
        got = [t.clone() for t in check()]
        ref = [t.clone() for t in plain(check)()]
        err, rel = compare(got, ref)
        ms, pms = cuda_ms(timed), cuda_ms(plain(timed))
        bound_ms = 1e3 * planes * n * L * 4 / HBM_BYTES_PER_S
        print(f"(u) {name} at (N1, N2) = ({n1}, {n2}), {L} lanes: "
              f"{rel:.3e} of the peak vs plain; {ms:.4f} ms, plain "
              f"{pms:.4f}, bytes bound {bound_ms:.4f} ms [{gpu}]",
              flush=True)
        if rel > FFT_TOL:
            raise AssertionError(f"config 4 {name}: {rel:.3e} of the peak")
        times[name] = ms
    forms = (dd.k1_form(n1, L, "k1_window"), dd.k1_form(n1, L, "k1_stream"),
             dd.k2_form("k2", n2, L))
    print(f"(u) forms at config 4's columns: k1_window {forms[0]}, "
          f"k1_stream {forms[1]}, k2 {forms[2]}", flush=True)
    return times


def drive_config4(dev, gpu):
    """Phase (u): BASELINE config 4 from a VDIF file on disk, through
    StreamRunner: packed ingest (words shipped, decoded on the card in
    step_fn: k1_window, k2, k3_trim a block) and float ingest (host LUT
    decode, planes through planes_step: k1_stream, k2, k3_trim a block),
    launches counted exactly, the two held together (rtol 1e-4, atol
    1e-6, counts exact), each against the same chain on the plain
    versions and against the eager chain read through the VDIF reader;
    then 48 blocks streamed and timed, by layer, with the card's idle
    share; then one Mark 5B, DADA and GUPPI file each decoded on the card
    against the host decode, bit for bit.  Returns the launches."""
    import tempfile
    from baseband_tasks_tpu_torch import CompiledPipeline, StreamRunner
    from baseband_tasks_tpu_torch import native
    from baseband_tasks_tpu_torch.models.compiled import (
        init_reduction_acc, make_reduction_update)
    from baseband_tasks_tpu_torch.models.runner import _PinnedRing
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    block, spf = config4_block(dev)
    print(f"(u) config 4: block {block}, file frames {spf}, "
          f"{C4_THREADS} threads of 8-bit complex at {C4_RATE} Hz",
          flush=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/config4.vdif"
        t0 = time.perf_counter()
        write_config4(path, block, spf,
                      max(C4_TIME_BLOCKS, C4_CHECK_BLOCKS))
        raw = np.fromfile(path, np.uint8)
        print(f"(u) wrote {raw.size / 2 ** 20:.1f} MiB in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        fr_p, ded, tail_p = config4_chain(path, dev, block)
        fr_f, _, tail_f = config4_chain(path, dev, block)
        geometry = (ded.engine, ded._padded_samples_per_frame, ded.pad_start,
                    ded.pad_end, ded.samples_per_frame, fr_p.packed_alignment)
        print(f"(u) engine, window, pads, frame, file frame: {geometry}",
              flush=True)
        if geometry != ("pallas", 1 << 17, 512, 512, block, spf):
            raise AssertionError(f"config 4 geometry {geometry}")
        cp_p = CompiledPipeline(tail_p, block_samples=block, packed=True)
        cp_f = CompiledPipeline(tail_f, block_samples=block)
        runner_p, runner_f = StreamRunner(cp_p), StreamRunner(cp_f,
                                                              planes=True)
        n = C4_CHECK_BLOCKS
        s_p, c_p, lp = counted_run("packed", runner_p, n, {
            "k1_window": n, "k2": n, "k3_trim": n})
        s_f, c_f, lf = counted_run("float (planes)", runner_f, n, {
            "k1_stream": n, "k2": n, "k3_trim": n})
        for k, v in (*lp.items(), *lf.items()):
            launches[k] = launches.get(k, 0) + v
        err = float(((s_p - s_f).abs() / (1e-6 + 1e-4 * s_f.abs())).max())
        finite = bool(torch.isfinite(s_p).all() and torch.isfinite(s_f).all())
        print(f"(u) packed vs float: sums {tuple(s_p.shape)}, counts "
              f"{sorted(set(c_p.tolist()))}; {err:.3e} of the rtol 1e-4 / "
              f"atol 1e-6 bound [{gpu}]", flush=True)
        if err > 1 or not torch.equal(c_p, c_f) or not finite:
            raise AssertionError("config 4: packed and float disagree")
        # the same chains on the plain versions (decode and reduction are
        # plain torch on both sides)
        for name, runner, got in (("packed", runner_p, s_p),
                                  ("float", runner_f, s_f)):
            with dd.plain_versions():
                ref, rcnt = runner.run(n)
            torch.cuda.synchronize()
            rel = float(((got - ref).abs() / (1e-6 + 1e-4 * ref.abs())).max())
            print(f"(u) {name} vs the plain versions: {rel:.3e} of the "
                  f"rtol 1e-4 / atol 1e-6 bound", flush=True)
            if rel > 1 or not torch.equal(rcnt, c_p):
                raise AssertionError(f"config 4 {name}: kernels disagree "
                                     f"with the plain versions")
        # the eager chain through the VDIF reader: bins the compiled run
        # filled completely (the first hold the carries' warmup)
        full = (c_p == C4_AVG).nonzero().flatten()
        lo, hi = int(full[0]), int(full[-1]) + 1
        fr_e, _, tail_e = config4_chain(path, dev, block)
        tail_e.seek(lo)
        eager = tail_e.read(hi - lo)
        comp = s_p[lo:hi] / C4_AVG
        ratio = float(((comp - eager).abs()
                       / (EAGER_ATOL + EAGER_RTOL * eager.abs())).max())
        print(f"(u) compiled vs eager bins {lo}..{hi}: {ratio:.3e} of the "
              f"rtol 1e-3 / atol 2e-3 bound (level "
              f"{float(eager.mean()):.1f}) [{gpu}]", flush=True)
        fr_e.close()
        if ratio > 1 or hi - lo < n * block // C4_AVG - 2:
            raise AssertionError("config 4: compiled disagrees with eager")
        del s_p, s_f, c_p, c_f, ref, eager, comp

        # -- the steady state: 48 blocks streamed, in turns ----------------
        m = C4_TIME_BLOCKS
        t0 = time.perf_counter()
        cp_p.segment_ids_np(m)
        ids_ms = 1e3 * (time.perf_counter() - t0)
        # a runner's first run of m blocks computes their segment ids on
        # the host and keeps them on the card: timed apart
        first, best = {}, {}
        for key in ("packed", "float", "float", "packed", "packed", "float"):
            runner = runner_p if key == "packed" else runner_f
            dt = host_s(lambda: runner.run(m), turns=1)
            if key not in first:
                first[key] = dt
            else:
                best[key] = min(best.get(key, np.inf), dt)
        samples = m * block * C4_THREADS
        words, mask = fr_p.read_packed(0, block)
        packed_bytes = words.nbytes + mask.nbytes
        planes_bytes = 2 * 4 * block * C4_THREADS
        t0 = time.perf_counter()
        native.unpack_8bit(raw)
        host_dt = time.perf_counter() - t0
        for key, dt in best.items():
            print(f"(u) config 4 {key}: {samples / dt:.4e} samples/s, "
                  f"{1e3 * dt / m:.3f} ms per block, {m} blocks of {block} "
                  f"x {C4_THREADS}, best of 2 runs; the first run (segment "
                  f"ids computed, {ids_ms:.1f} ms on the host) "
                  f"{1e3 * first[key] / m:.3f} ms per block [{gpu}]",
                  flush=True)
        print(f"(u) host decode (native.unpack_8bit over the file): "
              f"{raw.size / host_dt:.4e} bytes/s = samples/s of components "
              f"(native library: {native.available()}); bytes across the "
              f"boundary per block: packed {packed_bytes}, float planes "
              f"{planes_bytes} ({planes_bytes / packed_bytes:.2f}x)",
              flush=True)
        del raw

        # -- by layer ------------------------------------------------------
        def host_ms(fn, turns=3):
            best_dt = np.inf
            for _ in range(turns):
                t = time.perf_counter()
                fn()
                best_dt = min(best_dt, time.perf_counter() - t)
            return 1e3 * best_dt
        read_p = host_ms(lambda: fr_p.read_packed(block, block))
        read_f = host_ms(lambda: fr_f.read_host(block, block))
        host_f = fr_f.read_host(block, block)
        ring = _PinnedRing(torch.device(dev), 1)
        compute = torch.cuda.current_stream(dev)
        planes_host = (host_f.real, host_f.imag)

        def h2d(item):
            def go():
                out, ev = ring.ship(item, compute)
                ev.synchronize()
                return out
            return go
        h2d_p = host_ms(h2d((words, mask)))
        h2d_f = host_ms(h2d(planes_host))
        dev_words = (torch.as_tensor(words, device=dev),
                     torch.as_tensor(mask, device=dev))
        decode = cp_p._decoders[0]
        dec_ms = cuda_ms(lambda: decode(dev_words))
        kern = check_config4_kernels(dev, block, gpu)
        y = torch.rand((block, C4_THREADS), device=dev)
        ids_np, n_seg = cp_p.segment_ids_np(1)
        ids = torch.as_tensor(ids_np[0], device=dev)
        update = make_reduction_update(cp_p.reduction)
        sums, cnts = init_reduction_acc(cp_p.reduction, (C4_THREADS,), n_seg,
                                        dev)
        red_ms = cuda_ms(lambda: update(sums, cnts, y, ids))
        # the consumer's share: the steps alone on blocks already on the
        # card (the Python of the step and its launches, no reads)
        k = C4_PROFILE_BLOCKS
        on_card = cp_p.read_source_blocks(k)
        run_p = cp_p.run_fn(k)
        step_p = 1e3 * host_s(lambda: run_p(on_card), turns=3) / k
        on_card = cp_f.read_source_blocks(k)
        planes = [(b.real.contiguous(), b.imag.contiguous())
                  for b in on_card]
        pstep = cp_f.planes_step()

        def run_f():
            carry = cp_f.init_carry(planes=True)
            for b in planes:
                carry, (yr, _) = pstep(carry, b)
                update(sums, cnts, yr, ids)
        step_f = 1e3 * host_s(run_f, turns=3) / k
        del on_card, planes
        print(f"(u) config 4 steps alone on blocks on the card: packed "
              f"{step_p:.3f} ms per block (decode, kernels, reduction), "
              f"float planes {step_f:.3f} [{gpu}]", flush=True)
        print(f"(u) config 4 by layer, ms per block: host read packed "
              f"{read_p:.3f} / float (LUT decode) {read_f:.3f}; H2D through "
              f"the pinned ring packed {h2d_p:.3f} / float planes "
              f"{h2d_f:.3f}; decode on the card {dec_ms:.4f}; k1_window "
              f"{kern['k1_window']:.4f}, k1_stream {kern['k1_stream']:.4f}, "
              f"k2 {kern['k2']:.4f}, k3_trim {kern['k3_trim']:.4f}; "
              f"reduction (index_add_) {red_ms:.4f} [{gpu}]", flush=True)
        for key, runner in (("packed", runner_p), ("float", runner_f)):
            print_profile(f"(u) config 4 {key}, per block",
                          lambda: runner.run(C4_PROFILE_BLOCKS),
                          C4_PROFILE_BLOCKS, gpu)
        fr_p.close()
        fr_f.close()
        check_other_formats(dev, tmp, gpu)
    return launches


def check_other_formats(dev, tmp, gpu):
    """One Mark 5B (2-bit, 4 channels), DADA (8-bit complex, 2 pols x 4
    channels) and GUPPI (8-bit, 4 channels x 2 pols) file each, written by
    the port: read_packed, decoded on the card, against the host decode,
    bit for bit."""
    from baseband_tasks_tpu_torch import NoiseGenerator, Time, units as u
    from baseband_tasks_tpu_torch.io import dada, guppi, mark5b
    rng = np.random.default_rng(5)
    t0 = Time.from_mjd(58000.0)

    def template(shape, rate, dtype):
        return NoiseGenerator(shape=shape, start_time=t0,
                              sample_rate=rate * u.Hz, samples_per_frame=4096,
                              dtype=dtype, device="cpu")

    def cplx(shape, scale):
        x = rng.standard_normal(shape + (2,)).astype(np.float32) * scale
        return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    cases = []
    data = rng.standard_normal((200000, 4)).astype(np.float32)
    path = f"{tmp}/x.m5b"
    with mark5b.open(path, "w", template=template(data.shape, 10_000_000,
                                                  np.float32)) as fw:
        fw.write(data)
    cases.append(("mark5b", mark5b.open(path, nchan=4, ref_time=t0,
                                        sample_rate=10_000_000 * u.Hz,
                                        device=dev)))
    data = cplx((1 << 16, 2, 4), 10)
    path = f"{tmp}/x.dada"
    with dada.open(path, "w", template=template(data.shape, 1_000_000,
                                                np.complex64), nbit=8) as fw:
        fw.write(data)
    cases.append(("dada", dada.open(path, device=dev)))
    data = cplx((1 << 16, 4, 2), 1)
    path = f"{tmp}/x.raw"
    with guppi.open(path, "w", template=template(data.shape, 3_000_000,
                                                 np.complex64),
                    samples_per_block=8192) as fw:
        fw.write(data)
    cases.append(("guppi", guppi.open(path, device=dev)))
    for name, reader in cases:
        with reader:
            align = reader.packed_alignment
            count = reader.shape[0] // align * align
            packed = reader.read_packed(0, count)
            on_card = (tuple(torch.as_tensor(p, device=dev) for p in packed)
                       if isinstance(packed, tuple)
                       else torch.as_tensor(packed, device=dev))
            got = reader.packed_decode_fn()(on_card)
            want = torch.from_numpy(np.ascontiguousarray(
                reader.read_host(0, count)))
            same = (got.device == reader.device
                    and torch.equal(got.cpu(), want))
            print(f"(u) {name}: {count} samples of {tuple(got.shape[1:])}, "
                  f"decoded on the card {'==' if same else '!='} the host "
                  f"decode (bit for bit) [{gpu}]", flush=True)
            if not same:
                raise AssertionError(f"{name}: card decode differs")


# -- the analysis slice beyond the reference: (v1)-(v6) ---------------------

FRB_RATE, FRB_CHAN, FRB_DM = 16e6, 128, 26.7    # examples/frb_search.py
FRB_BURST = 200_000          # raw sample of the burst
# the example's 2^19 samples keep 'pallas' (one 411,648-sample frame, pads
# 57,344 / 55,296 on the N2 grid) but give 3216 spectra, fewer than the
# search's 4096: 2^20 samples give 7312 spectra in three frames
FRB_N = 1 << 20
FRB_DMS = np.linspace(0, 60, 121)
FRB_NTIME = 4096
# sharded against one search, fdf and the secondary against float64, of
# the peak (float32 roundoff is ~1e-6 of it)
SEARCH_TOL = 1e-5
POL_BLOCKS, POL_BLOCK, POL_CHAN = 64, 1 << 18, 128  # bench_full polarization()
POL_EAGER_BLOCKS = 4
CF_BLOCKS, CF_PHASE, CF_F0 = 16, 32, 123.456  # examples/calibrated_fold.py
CF_JONES = np.array([[1.15, 0.08 + 0.03j], [-0.05j, 0.92]], np.complex64)
FAR_RM, FAR_BLOCKS, FAR_AVG = 100.0, 4, 1024
RM_BATCH, RM_CHAN, RM_PHI = 4096, 1024, 1024   # bench_full rmsearch()
SEC_T, SEC_F = 4096, 2048                       # bench_full secondary()


def frb_chain(dev):
    """examples/frb_search.py's chain on ``dev``: 16 MHz complex noise
    (seed 42) with a 40-sigma, 3-sample burst at raw sample 200,000,
    labelled 800 MHz -> Disperse(26.7, 'pallas') -> Channelize(128) ->
    Square.  Returns (the Disperse node, the tail)."""
    from baseband_tasks_tpu_torch import (Channelize, Disperse, Noise,
                                          SetAttribute, Square,
                                          StreamGenerator, Time, units as u)
    noise = Noise(42)

    def burst(fh):
        data = noise(fh)
        idx = torch.arange(fh.tell(), fh.tell() + len(data),
                           dtype=torch.float64, device=data.device)
        amp = 40.0 * torch.exp(-0.5 * ((idx - FRB_BURST) / 3.0) ** 2)
        return data + amp.to(torch.float32)
    gen = StreamGenerator(burst, (FRB_N,), Time("2021-03-01T00:00:00.0"),
                          FRB_RATE * u.Hz, samples_per_frame=1 << 15,
                          dtype=np.complex64, device=dev)
    dispersed = Disperse(SetAttribute(gen, frequency=800 * u.MHz,
                                      sideband=1), FRB_DM, engine="pallas")
    return dispersed, Square(Channelize(dispersed, FRB_CHAN))


def rel_err(got, ref):
    """Max |got - ref| over max |ref|."""
    return float((got - ref).abs().max()) / float(ref.abs().max())


def check_burst(tag, t, dm, expected_t, phase="(v1)"):
    print(f"{phase} {tag}: peak at spectrum {t}, trial DM {dm:.2f} "
          f"(expected {expected_t}, {FRB_DM})", flush=True)
    if abs(dm - FRB_DM) > 1.0 or abs(t - expected_t) >= 40:
        raise AssertionError(f"FRB {tag}: burst at ({t}, {dm}), expected "
                             f"({expected_t}, {FRB_DM})")


def drive_frb(dev, gpu, tmp):
    """Phase (v1), the FRB search: the chain read on the card with its
    launches counted (k1_window, k2, k3_trim once a Disperse frame), the
    filterbank written by the SIGPROC writer and read back bit for bit,
    ``DMTrialSearch`` detect / candidates / search_stream recovering the
    burst within the example's tolerances, the map against the chain on
    the plain versions, ``search_sharded`` on four shards of the card,
    the monitor against CUDA events, a trace; search and detect timed.
    Returns the launch counts."""
    import os
    from baseband_tasks_tpu_torch import (DispersionMeasure, SetAttribute,
                                          open as bopen, units as u)
    from baseband_tasks_tpu_torch.io import sigproc
    from baseband_tasks_tpu_torch.models import DMTrialSearch
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.parallel import Mesh
    from baseband_tasks_tpu_torch.utils.profiling import monitor, trace
    dispersed, power = frb_chain(dev)
    n_frames = -(-dispersed.shape[0] // dispersed.samples_per_frame)
    geom = (dispersed.engine, dispersed._padded_samples_per_frame,
            dispersed.pad_start, dispersed.pad_end,
            dispersed.samples_per_frame, n_frames, tuple(power.shape))
    print(f"(v1) FRB chain: engine, window, pads, frame, frames, "
          f"filterbank {geom}", flush=True)
    if dispersed.engine != "pallas":
        raise AssertionError(f"FRB Disperse runs {dispersed.engine!r}")
    dd.reset_launch_counts()
    fb = power.read()
    torch.cuda.synchronize()
    launches = {k: v for k, v in dd.launch_counts.items() if v}
    want = {k: n_frames for k in ("k1_window", "k2", "k3_trim")}
    print(f"(v1) FRB read: launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"FRB launches {launches}, expected {want}")
    # the monitor (the card synchronized in each counted frame) against
    # CUDA events recorded around the same frames inside it: a monitor
    # that timed only the launches could come out below them
    events = []
    inner = power._read_frame

    def evented(frame_index):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = inner(frame_index)
        pair[1].record()
        events.append(pair)
        return out
    power._read_frame = evented
    mons = monitor(power)
    power.seek(0)
    power.read()
    torch.cuda.synchronize()
    ev_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    tail = mons[0]
    print(f"(v1) monitor {tail.report()}; CUDA events of the same frames "
          f"{1e3 * ev_s:.3f} ms [{gpu}]", flush=True)
    if tail.samples != power.shape[0] or tail.seconds < ev_s:
        raise AssertionError("FRB monitor: samples or seconds wrong")
    # the filterbank through the SIGPROC writer (channels in frequency
    # order) and back
    freq = np.asarray(power.frequency.to_value(u.MHz)).reshape(-1)
    order = np.argsort(freq)
    path = os.path.join(tmp, "frb.fil")
    with sigproc.open(path, "w", template=SetAttribute(
            power, frequency=freq[order] * u.MHz), source_name="FRB") as fw:
        fw.write(fb[:, order])
    rh = bopen(path, device=dev)
    back = rh.read()
    if not torch.equal(back, fb[:, order]):
        raise AssertionError("FRB filterbank changed through SIGPROC")
    search = DMTrialSearch(rh.frequency, rh.sample_rate, FRB_DMS, FRB_NTIME,
                           device=dev)
    shift = (DispersionMeasure(FRB_DM).time_delay(
        search.reference_frequency, 800 * u.MHz).to_value(u.s) * FRB_RATE)
    expected_t = int((FRB_BURST + shift - dispersed.pad_start) / FRB_CHAN)
    block = back[:FRB_NTIME]
    snr, width = search.detect(block)
    t, j = np.unravel_index(np.argmax(snr), snr.shape)
    print(f"(v1) detect: S/N {snr[t, j]:.1f}, boxcar {int(width[t, j])}",
          flush=True)
    check_burst("detect", int(t), float(FRB_DMS[j]), expected_t)
    cands = search.candidates(block, threshold=8.0)
    if not cands:
        raise AssertionError("FRB: no candidate above S/N 8")
    print(f"(v1) candidates: {len(cands)}, first {cands[0]}", flush=True)
    check_burst("candidates", cands[0]["time_sample"], cands[0]["dm"],
                expected_t)
    rh.seek(0)
    smap = search.search_stream(rh)
    ref_map = search.search(block)
    valid = FRB_NTIME - search.max_delay_samples
    err_st = rel_err(smap[:valid], ref_map[:valid])
    t, j = np.unravel_index(int(smap.argmax()), tuple(smap.shape))
    # the raw map's peak (no boxcar) is broad in DM: its time is checked
    print(f"(v1) search_stream {tuple(smap.shape)}: peak at spectrum {t}, "
          f"trial DM {FRB_DMS[j]:.2f}; its first {valid} rows vs search "
          f"{err_st:.3e} of the peak", flush=True)
    if abs(int(t) - expected_t) >= 40 or err_st > SEARCH_TOL:
        raise AssertionError("FRB search_stream wrong")
    with dd.plain_versions():
        _, plain_power = frb_chain(dev)
        plain_fb = plain_power.read(FRB_NTIME)
    err_fb = rel_err(fb[:FRB_NTIME], plain_fb)
    err_map = rel_err(ref_map, search.search(plain_fb[:, order]))
    sharded = search.search_sharded(block, Mesh([dev] * 4, ("dm",)))
    err_sh = rel_err(sharded, ref_map)
    print(f"(v1) kernels vs plain: filterbank {err_fb:.3e}, search map "
          f"{err_map:.3e} of the peak; search_sharded (4 shards) vs search "
          f"{err_sh:.3e} [{gpu}]", flush=True)
    if err_fb > FFT_TOL or err_map > FFT_TOL or err_sh > SEARCH_TOL:
        raise AssertionError("FRB search disagrees")
    ms = cuda_ms(lambda: search.search(block))
    detect_ms = 1e3 * host_s(lambda: search.detect(block), turns=3)
    tables = (search._phase_r, search._phase_i)
    bound_ms, by = bound((block, *tables), (ref_map,), 8 * tables[0].numel())
    print(f"(v1) DMTrialSearch {FRB_NTIME} x {FRB_CHAN} x {len(FRB_DMS)} "
          f"trials: search {ms:.4f} ms ({bound_ms:.4f} ms bound by {by}: "
          f"the {sum(t.numel() * 4 for t in tables) / 1e6:.1f} MB phase "
          f"tables read once), detect {detect_ms:.3f} ms (host included); "
          f"{FRB_NTIME * len(FRB_DMS) / ms * 1e3:.4e} trial-samples/s "
          f"[{gpu}]", flush=True)
    print_profile("(v1) one search", lambda: search.search(block), 1, gpu)
    with trace(os.path.join(tmp, "trace")) as out:
        search.search(block)
    size = os.path.getsize(os.path.join(out, "trace.json"))
    print(f"(v1) trace of one search: {size} bytes", flush=True)
    if not size:
        raise AssertionError("trace wrote nothing")
    rh.close()
    return launches


def block_source(dev, blocks, **attrs):
    """A stream on ``dev`` serving the stacked complex ``blocks`` (one a
    frame) at 1 MHz."""
    from baseband_tasks_tpu_torch import StreamGenerator, Time, units as u
    n_blocks, block = blocks.shape[:2]
    return StreamGenerator(lambda sh: blocks[sh.tell() // block],
                           shape=(n_blocks * block,) + tuple(blocks.shape[2:]),
                           start_time=Time("2020-01-01T00:00:00.0"),
                           sample_rate=1 * u.MHz, samples_per_frame=block,
                           dtype=np.complex64, device=dev, **attrs)


def complex_randn(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(tuple(shape) + (2,), generator=g, device=dev)
    return torch.view_as_complex(x)


def pol_chain(dev, blocks, with_pol):
    """``tools/bench_full.py`` polarization(): dual-pol blocks ->
    Channelize(128) [-> ConvertPolarization('circular') ->
    ApplyJones(inverse=True)] -> Square -> Integrate(64, sums), compiled
    one block a step.  Returns (tail, CompiledPipeline)."""
    from baseband_tasks_tpu_torch import (ApplyJones, Channelize,
                                          CompiledPipeline,
                                          ConvertPolarization, Integrate,
                                          Square)
    ch = Channelize(block_source(dev, blocks,
                                 polarization=np.array(["X", "Y"])),
                    POL_CHAN)
    if with_pol:
        jones = np.tile(np.array([[1.0, 0.05j], [-0.05j, 1.0]],
                                 np.complex64), (POL_CHAN, 1, 1))
        ch = ApplyJones(ConvertPolarization(ch, "circular"), jones,
                        inverse=True)
    tail = Integrate(Square(ch), 64, average=False)
    return tail, CompiledPipeline(tail, block_samples=POL_BLOCK)


def drive_polarization(dev, gpu):
    """Phase (v2): BASELINE polarization, 64 blocks of 2^18 dual-pol
    samples on the card, compiled with and without the two polarization
    stages, against the eager chain on the first 4 blocks (rtol 1e-3,
    atol 2e-3, counts exact), timed in turns: samples/s and
    pol_overhead."""
    blocks = complex_randn(dev, (POL_BLOCKS, POL_BLOCK, 2), 3)
    head = blocks[:POL_EAGER_BLOCKS]
    tail, cp = pol_chain(dev, head, True)
    sums, counts = cp.run_fn(POL_EAGER_BLOCKS)(head)
    eager = tail.read()
    torch.cuda.synchronize()
    counts = counts.reshape(tuple(counts.shape) + (1,) * (
        eager.count.ndim - counts.ndim)).expand(eager.count.shape)
    ok = (torch.equal(counts.to(eager.count.dtype), eager.count)
          and torch.allclose(sums.double(), eager.data.double(),
                             rtol=EAGER_RTOL, atol=EAGER_ATOL))
    print(f"(v2) polarization chain: compiled {tuple(sums.shape)} vs eager "
          f"{rel_err(sums, eager.data):.3e} of the peak, counts exact "
          f"({'ok' if ok else 'FAIL'}) [{gpu}]", flush=True)
    if not ok:
        raise AssertionError("polarization chain: compiled != eager")
    runs = {key: pol_chain(dev, blocks, key)[1].run_fn(POL_BLOCKS)
            for key in (False, True)}
    best = {}
    for key in (False, True, True, False):
        best[key] = min(best.get(key, np.inf),
                        host_s(lambda: runs[key](blocks), turns=10))
    n = POL_BLOCKS * POL_BLOCK * 2
    rate = {k: n / v for k, v in best.items()}
    print(f"(v2) polarization {POL_BLOCKS} x 2^18 x 2: with the pol stages "
          f"{1e3 * best[True]:.3f} ms ({rate[True]:.4e} samples/s), without "
          f"{1e3 * best[False]:.3f} ms ({rate[False]:.4e}); pol_overhead "
          f"{rate[False] / rate[True] - 1:.3f} [{gpu}]", flush=True)
    for key in (False, True):
        print_profile(f"(v2) polarization run, pol stages {key}, per block",
                      lambda: runs[key](blocks), POL_BLOCKS, gpu)


def calibrated_blocks(dev):
    """examples/calibrated_fold.py's voltages at (v2)'s width, made on the
    card: complex noise, a 10 %-duty pulsar (F0 123.456 Hz, +0.8 noise in
    the pulse) and a carrier at channel 5 of 128 in pol X, on for 8192
    samples of every 16384."""
    n = CF_BLOCKS * POL_BLOCK
    x = complex_randn(dev, (n, 2), 1234)
    k = torch.arange(n, device=dev, dtype=torch.float64)
    in_pulse = ((k / 1e6 * CF_F0) % 1.0) < 0.1
    x = x + 0.8 * in_pulse[:, None] * complex_randn(dev, (n, 2), 1235)
    on = ((k // 8192) % 2) == 0
    x[:, 0] += (6.0 * on * torch.exp(2j * np.pi * (5 / POL_CHAN) * k)).to(
        torch.complex64)
    return x.reshape(CF_BLOCKS, POL_BLOCK, 2)


def calibrated_chain(dev, blocks):
    """ApplyJones(J) -> ApplyJones(J, inverse=True) -> Channelize(128) ->
    ExciseSpectralKurtosis(64, fill=nan) -> Square -> Fold(32, masked,
    sums) of one block a fold row.  Returns (tail, CompiledPipeline)."""
    from baseband_tasks_tpu_torch import (ApplyJones, Channelize,
                                          CompiledPipeline,
                                          ExciseSpectralKurtosis, Fold,
                                          Square, Time, units as u)
    src = block_source(dev, blocks, polarization=np.array(["X", "Y"]))
    cal = ApplyJones(ApplyJones(src, CF_JONES), CF_JONES, inverse=True)
    chain = Square(ExciseSpectralKurtosis(Channelize(cal, POL_CHAN), 64,
                                          threshold=3.0, fill=np.nan))
    t0 = Time("2020-01-01T00:00:00.0")
    phase = (lambda t: u.Quantity((t - t0).sec * CF_F0, u.cycle))
    tail = Fold(chain, CF_PHASE, phase, u.Quantity(POL_BLOCK / 1e6, u.s),
                samples_per_frame=1, masked=True, average=False)
    return tail, CompiledPipeline(tail, block_samples=POL_BLOCK)


def drive_calibrated_fold(dev, gpu):
    """Phase (v3): the calibrated masked fold compiled against eager, flag
    for flag (the fold's per-cell counts exact, sums rtol 1e-4), the RFI
    channel found, the profile's contrast and unbiased mean as the example
    asserts them, the flagged share printed, a TOA fitted to the profile
    (``ProfileTemplate.toa``), the compiled run timed."""
    from baseband_tasks_tpu_torch import ProfileTemplate, Time, units as u
    blocks = calibrated_blocks(dev)
    tail, cp = calibrated_chain(dev, blocks)
    run = cp.run_fn(CF_BLOCKS)
    sums, counts = run(blocks)
    eager = tail.read()
    torch.cuda.synchronize()
    same_flags = torch.equal(counts.to(eager.count.dtype), eager.count)
    fin = eager.count > 0
    rel = float(((sums[fin] - eager.data[fin]).abs()
                 / eager.data[fin].abs()).max())
    total = CF_BLOCKS * POL_BLOCK * 2
    flagged = 1 - float(counts.sum()) / total
    kept = counts.sum(dim=(0, 1)).double()
    kept = kept / kept.max()
    rfi = int(kept[:, 0].argmin())
    mean = (sums / counts.clamp_min(1)).double()
    prof = mean.mean(dim=(0, 2, 3))
    contrast = float(prof.max() / prof.median())
    bias = float(mean[..., rfi, 0].mean() / mean[..., rfi - 2, 0].mean())
    print(f"(v3) calibrated fold: compiled vs eager counts "
          f"{'exact' if same_flags else 'DIFFER'}, sums rel {rel:.3e}; "
          f"flagged share {flagged:.4f}, RFI channel {rfi} (kept "
          f"{float(kept[rfi, 0]):.2f}), contrast {contrast:.2f}, masked "
          f"mean RFI/quiet {bias:.3f} [{gpu}]", flush=True)
    if (not same_flags or rel > 1e-4 or rfi != 5 or contrast <= 1.2
            or abs(bias - 1) >= 0.3):
        raise AssertionError("calibrated fold wrong")
    bins = (np.arange(CF_PHASE) + 0.5) / CF_PHASE
    template = ProfileTemplate((bins < 0.1).astype(np.float64))
    t0 = Time("2020-01-01T00:00:00.0")
    toa, err, snr = template.toa(prof.cpu().numpy(), time=t0,
                                 folded_phase=0.0,
                                 period=u.Quantity(1.0 / CF_F0, u.s))
    off = float((toa - t0).sec)
    print(f"(v3) TOA of the profile: {off * 1e6:.2f} us from the fold's "
          f"phase 0, error {err.to_value(u.s) * 1e6:.2f} us, S/N {snr:.1f}",
          flush=True)
    if not (abs(off) < 2 / CF_PHASE / CF_F0 and snr > 10):
        raise AssertionError("calibrated fold: TOA off")
    dt = host_s(lambda: run(blocks), turns=3)
    print(f"(v3) calibrated fold run of {CF_BLOCKS} x 2^18 x 2: "
          f"{1e3 * dt:.3f} ms ({total / dt:.4e} samples/s) [{gpu}]",
          flush=True)
    print_profile("(v3) calibrated fold run, per block", lambda: run(blocks),
                  CF_BLOCKS, gpu)


def faraday_chain(dev):
    """Phase (v4)'s chain: the flagship's band (64 channels x 2 pols at
    250 kHz around 1400 MHz, linear X/Y) of complex noise (seed 5) ->
    Dedisperse(500, 'pallas', a 2^18 window) -> DeFaraday(100 rad/m^2,
    linear) -> Square -> Integrate(1024), compiled."""
    from baseband_tasks_tpu_torch import (CompiledPipeline, DeFaraday,
                                          Dedisperse, Integrate,
                                          NoiseGenerator, SetAttribute,
                                          Square, Time, units as u)
    freq = flagship_on_host().freqs.to_value(u.MHz)[:, None] * u.MHz
    src = NoiseGenerator(shape=(1 << 21, 64, 2),
                         start_time=Time.from_mjd(58000.0),
                         sample_rate=250 * u.kHz, samples_per_frame=1 << 16,
                         seed=5, device=dev)
    src = SetAttribute(src, frequency=freq, sideband=1,
                       polarization=np.array(["X", "Y"]))
    ded = Dedisperse(src, 500.0, samples_per_frame=1 << 17, engine="pallas")
    far = DeFaraday(ded, FAR_RM, basis="linear")
    return far, CompiledPipeline(Integrate(Square(far), FAR_AVG))


def drive_faraday(dev, gpu):
    """Phase (v4): DeFaraday in a compiled planes chain behind a 'pallas'
    Dedisperse: ``planes_step`` over 4 blocks with k1_stream, k2, k3_trim
    once a block and DeFaraday.task_planes once a block, against the
    complex step and the plain versions (1e-4 of the peak); the absorbed
    Integrate against the plain versions; timed.  Returns the launch
    counts of the planes run."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    far, cp = faraday_chain(dev)
    _, ref = faraday_chain(dev)
    calls = []
    orig = far.task_planes
    far.task_planes = lambda pair: calls.append(1) or orig(pair)
    blocks = cp.read_source_blocks(FAR_BLOCKS)
    print(f"(v4) DeFaraday chain: block {cp.block_samples}, delay "
          f"{cp.delay}, window {far.ih._padded_samples_per_frame}, pads "
          f"({far.ih.pad_start}, {far.ih.pad_end})", flush=True)

    def planes(pipe):
        step, carry = pipe.planes_step(), pipe.init_carry(planes=True)
        outs = []
        for b in blocks:
            carry, (yr, yi) = step(carry, b)
            outs.append(yr)
        return torch.cat(outs)

    dd.reset_launch_counts()
    got = planes(cp)
    torch.cuda.synchronize()
    launches = {k: v for k, v in dd.launch_counts.items() if v}
    want = {k: FAR_BLOCKS for k in ("k1_stream", "k2", "k3_trim")}
    print(f"(v4) planes step: launches {launches}, DeFaraday.task_planes "
          f"calls {len(calls)}", flush=True)
    if launches != want or len(calls) != FAR_BLOCKS:
        raise AssertionError(f"DeFaraday chain: launches {launches}, "
                             f"task_planes calls {len(calls)}")
    step, carry = cp.step_fn(), cp.init_carry()
    comp = []
    for b in blocks:
        carry, y = step(carry, b)
        comp.append(y)
    err_c = rel_err(got, torch.cat(comp))
    with dd.plain_versions():
        err_p = rel_err(got, planes(ref))
        avg_p, _ = ref.run_reduced(blocks)
    avg, cnt = cp.run_reduced(blocks)
    err_i = rel_err(avg, avg_p)
    print(f"(v4) planes vs the complex step {err_c:.3e}, vs plain "
          f"{err_p:.3e}; Integrate({FAR_AVG}) {tuple(avg.shape)} vs plain "
          f"{err_i:.3e} of the peak [{gpu}]", flush=True)
    if (max(err_c, err_p, err_i) > FFT_TOL
            or not bool(torch.isfinite(avg).all())):
        raise AssertionError("DeFaraday chain disagrees")
    dt = host_s(lambda: planes(cp), turns=3)
    print(f"(v4) DeFaraday planes chain: {1e3 * dt / FAR_BLOCKS:.3f} ms per "
          f"block of {cp.block_samples} x 128 [{gpu}]", flush=True)
    print_profile("(v4) DeFaraday planes chain, per block",
                  lambda: planes(cp), FAR_BLOCKS, gpu)
    return launches


def drive_rmsearch(dev, gpu):
    """Phase (v5): BASELINE rmsearch, (4096, 1024) Q/U planes against 1024
    depths: ``fdf`` timed, 64 rows against float64 numpy and
    ``fdf_sharded`` on four shards of the card against ``fdf`` (1e-5 of
    the peak)."""
    from baseband_tasks_tpu_torch import units as u
    from baseband_tasks_tpu_torch.models import RMSynthesis
    from baseband_tasks_tpu_torch.parallel import Mesh
    freq = (1200 + 0.25 * np.arange(RM_CHAN)) * u.MHz
    rm = RMSynthesis(freq, np.linspace(-500, 500, RM_PHI), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    q, u_ = torch.randn((2, RM_BATCH, RM_CHAN), generator=g, device=dev)
    f = rm.fdf(q, u_)
    theta = -2.0 * np.outer(rm.lam2 - rm.lam2_0, rm.phis)
    p = q[:64].double().cpu().numpy() + 1j * u_[:64].double().cpu().numpy()
    want = torch.from_numpy(p @ np.exp(1j * theta) / RM_CHAN)
    err64 = rel_err(f[:64].cpu().to(torch.complex128), want)
    err_sh = rel_err(rm.fdf_sharded(q, u_, Mesh([dev] * 4, ("phi",))), f)
    ms = cuda_ms(lambda: rm.fdf(q, u_))
    bound_ms, by = bound((q, u_, rm._tr, rm._ti), (f,),
                         4 * 2 * RM_BATCH * RM_CHAN * RM_PHI)
    print(f"(v5) RMSynthesis {RM_BATCH} x {RM_CHAN} x {RM_PHI}: 64 rows vs "
          f"float64 {err64:.3e}, fdf_sharded (4 shards) vs fdf {err_sh:.3e} "
          f"of the peak; fdf {ms:.4f} ms ({bound_ms:.4f} ms bound by {by}), "
          f"{RM_BATCH * RM_CHAN * RM_PHI / ms * 1e3:.4e} trial-samples/s "
          f"[{gpu}]", flush=True)
    if err64 > SEARCH_TOL or err_sh > SEARCH_TOL:
        raise AssertionError("RM synthesis disagrees")


def drive_secondary(dev, gpu):
    """Phase (v6): BASELINE secondary, a (4096, 2048) dynamic spectrum
    (normals + 10): ``secondary_spectrum`` against float64 numpy (1e-5 of
    the peak), timed."""
    from baseband_tasks_tpu_torch.models import secondary_spectrum
    g = torch.Generator(device=dev).manual_seed(2)
    d = torch.randn((SEC_T, SEC_F), generator=g, device=dev) + 10.0
    S, _, _ = secondary_spectrum(d)
    x = d.double().cpu().numpy()
    x = x - x.mean(axis=-2, keepdims=True)
    x = x - x.mean(axis=-1, keepdims=True)
    want = np.fft.fftshift(np.abs(np.fft.rfft2(x)) ** 2, axes=-2)
    err = rel_err(S.cpu().double(), torch.from_numpy(want))
    ms = cuda_ms(lambda: secondary_spectrum(d))
    bound_ms, by = bound((d,), (S,), 2.5 * d.numel() * np.log2(d.numel())
                         + 4 * d.numel() + 3 * S.numel())
    print(f"(v6) secondary spectrum {SEC_T} x {SEC_F}: vs float64 {err:.3e} "
          f"of the peak; {ms:.4f} ms ({bound_ms:.4f} ms bound by {by}), "
          f"{SEC_T * SEC_F / ms * 1e3:.4e} samples/s [{gpu}]", flush=True)
    if err > SEARCH_TOL or tuple(S.shape) != (SEC_T, SEC_F // 2 + 1):
        raise AssertionError("secondary spectrum disagrees")


def drive_analysis(dev, gpu):
    """Phase (v): the six paths beyond the reference.  Returns the launch
    counts of (v1) and (v4)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        launches = dict(drive_frb(dev, gpu, tmp))
    torch.cuda.empty_cache()
    drive_polarization(dev, gpu)
    torch.cuda.empty_cache()
    drive_calibrated_fold(dev, gpu)
    torch.cuda.empty_cache()
    for k, v in drive_faraday(dev, gpu).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    drive_rmsearch(dev, gpu)
    drive_secondary(dev, gpu)
    torch.cuda.empty_cache()
    return launches


# -- sharded compiles and the stored-file paths: phase (w) ------------------

W_SHARDS = 4                 # virtual shards of the card along 'time'
W_BLOCKS = 8                 # source blocks a sharded run: two super-steps
# config 3's blocks are 32256 spectra x 256 = 8,257,536 samples: eight of
# them need a source longer than the 2^24 of (h)
W_SOURCE = {"config2": 1 << 23, "config3_quad": 1 << 26}
W_RTOL = 1e-6                # sharded against one device (bit-exact in JAX)
W_HDF5_RTOL, W_HDF5_ATOL = 1e-5, 1e-6   # the JAX packed padded chain's
W_NSBLK = 1024               # search-mode PSRFITS rows of the filterbank


def w_check_pads(tag, name, cp):
    """Every padded stage's pad against its per-shard block: the
    refusal's condition.  Returns the stages that would be refused."""
    pads = [(type(st.node).__name__, st.pad, st.in_block)
            for st in cp.stages if st.padded and not st.skip]
    over = [p for p in pads if p[1] > p[2]]
    verdict = (f"pads above the block {over}" if over else
               "every pad within its per-shard block, no refusal")
    print(f"{tag} {name}: block {cp.block_samples} source samples -> "
          f"{cp.tail_block}; padded stages (name, pad, per-shard block) "
          f"{pads}: {verdict}", flush=True)
    return over


def drive_sharded_compiled(name, dev, gpu, tag):
    """(w1)/(w2): compiled path ``name`` through ``ShardedPipeline`` on
    W_SHARDS virtual shards of the card for W_BLOCKS blocks, against the
    one-device ``CompiledPipeline`` on the same blocks (rtol W_RTOL, the
    launches of each run equal), both timed in ms a block, in turns, and
    the sharded run profiled.  Returns the sharded run's launches, its ms
    a block and the SHA-256 of each output block's bytes (phase (x))."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    from baseband_tasks_tpu_torch.models import ShardedPipeline
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    cp = CompiledPipeline(compiled_tail(name, dev,
                                        n_samples=W_SOURCE[name]))
    fused = [type(st.fused).__name__ for st in cp.stages
             if getattr(st, "fused", None) is not None]
    if fused != COMPILED[name][0]:
        raise AssertionError(f"{tag} {name}: fused {fused}")
    sp = ShardedPipeline(cp, virtual_mesh(dev, W_SHARDS, 1))
    blocks = cp.read_source_blocks(W_BLOCKS)
    torch.cuda.synchronize()
    if w_check_pads(tag, name, cp):
        # the JAX refusal, then the block its docstring asks for: frames
        # large enough that every pad fits one shard's block
        try:
            sp.run_blocks(blocks)
        except ValueError as exc:
            print(f"{tag} {name}: refused as expected: {exc}", flush=True)
        raise AssertionError(f"{tag} {name}: rebuild with a larger "
                             f"samples_per_frame (no path here needs it)")
    dd.reset_launch_counts()
    got = sp.run_blocks(blocks)
    torch.cuda.synchronize()
    counts = nonzero(dd.launch_counts)
    dd.reset_launch_counts()
    ref = cp.run_blocks(blocks)
    torch.cuda.synchronize()
    one = nonzero(dd.launch_counts)
    print(f"{tag} {name}: launches sharded {counts}, one device {one} "
          f"[{gpu}]", flush=True)
    if counts != one or any(counts.get(k, 0) <= 0
                            for k in W_KERNELS[name]):
        raise AssertionError(f"{tag} {name}: launches differ or a kernel "
                             f"of {W_KERNELS[name]} is missing")
    diff = (got - ref).abs()
    peak = float(ref.abs().max())
    err, rel = float(diff.max()), float((diff / ref.abs()).nan_to_num(
        0.0, posinf=0.0).max())
    want = (W_BLOCKS * cp.tail_block,) + tuple(cp._tail.sample_shape)
    print(f"{tag} {name}: {tuple(got.shape)}, sharded vs one device: "
          f"largest difference {err:.3e} ({err / peak:.3e} of the peak), "
          f"largest relative {rel:.3e} [{gpu}]", flush=True)
    if (tuple(got.shape) != want or not torch.isfinite(
            torch.view_as_real(got)).all()
            or not torch.allclose(got, ref, rtol=W_RTOL,
                                  atol=W_RTOL * peak)):
        raise AssertionError(f"{tag} {name}: sharded disagrees")
    digests = block_digests(got, cp.tail_block)
    del got, ref
    runs = {"one device": lambda: cp.run_blocks(blocks),
            "sharded": lambda: sp.run_blocks(blocks)}
    ms = best_ms(runs, ("one device", "sharded", "sharded", "one device"),
                 W_BLOCKS)
    print(f"{tag} {name}: {ms['sharded']:.3f} ms a block sharded "
          f"({W_SHARDS} shards of the card), {ms['one device']:.3f} ms one "
          f"device ({ms['sharded'] / ms['one device']:.2f}x); "
          f"{cp.tail_block / ms['sharded'] * 1e3:.4e} output samples/s "
          f"sharded [{gpu}]", flush=True)
    wall, busy, rows = device_profile(lambda: sp.run_blocks(blocks))
    print(f"{tag} {name} profiled sharded run: {wall / W_BLOCKS:.3f} ms a "
          f"block wall, {busy / W_BLOCKS:.3f} device busy "
          f"({busy / wall:.2f}) [{gpu}]", flush=True)
    for dev_us, count, key in rows[:6]:
        print(f"{tag}   {dev_us / 1e3 / W_BLOCKS:8.3f} ms/block  "
              f"x{count:<3d} {key[:70]} [{gpu}]", flush=True)
    return counts, ms["sharded"], digests


def block_digests(out, tail_block):
    """SHA-256 of the bytes of each ``tail_block``-sample output block."""
    import hashlib
    host = out.cpu().numpy()
    return [hashlib.sha256(host[k:k + tail_block].tobytes()).digest()
            for k in range(0, host.shape[0], tail_block)]


# which kernels each sharded path must launch: the complex step (as in
# the JAX package) assembles each window and runs the fusions' window
# form, k1_window; its forward FIR is the FIR node's own torch task, so
# pfb_fwd runs on the planes step only
W_KERNELS = {"config2": ("k1_window", "k2", "k3_trim", "lane_mix"),
             "config3_quad": ("k1_window", "k2", "k3_trim")}


def drive_sharded_view(dev, gpu):
    """(w3): ``compile(mesh=)`` of config 2 read whole through the view,
    on a source of 9.5 blocks: two super-steps compiled, the warm-up and
    the remainder (one block and a half, fewer than S) served eagerly.
    Against the eager chain: the eager parts bit for bit, the compiled
    windows (block 1) to the eager bound of (h); against the one-device
    view where both compile.  Returns the view's launches."""
    from baseband_tasks_tpu_torch import CompiledPipeline
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    B = CompiledPipeline(compiled_tail("config2", dev)).block_samples
    n = (2 * W_SHARDS + 1) * B + B // 2
    view = compiled_tail("config2", dev, n_samples=n).compile(
        mesh=virtual_mesh(dev, W_SHARDS, 1), shard_axis="time")
    cp = view.cp
    d, w, tb = int(cp.delay), cp.warmup, cp.tail_block
    print(f"(w3) config2 view: {view.shape[0]} samples, {view._S} shards, "
          f"{view._max_blocks} blocks compiled of {n // B}, delay {d}, "
          f"warmup {w}", flush=True)
    if view._S != W_SHARDS or view._max_blocks != 2 * W_SHARDS:
        raise AssertionError("(w3) view geometry wrong")
    dd.reset_launch_counts()
    t0 = time.perf_counter()
    got = view.read()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = nonzero(dd.launch_counts)
    print(f"(w3) view read: {1e3 * dt:.1f} ms for {got.shape[0]} samples, "
          f"launches {launches} [{gpu}]", flush=True)
    eager = compiled_tail("config2", dev, n_samples=n).read()
    single = compiled_tail("config2", dev, n_samples=n).compile().read()
    torch.cuda.synchronize()
    lo, hi = w - d, 2 * W_SHARDS * tb - d
    head = torch.equal(got[:lo], eager[:lo])
    rest = torch.equal(got[hi:], eager[hi:])
    diff = (got[lo:hi] - single[lo:hi]).abs()
    err = float(diff.max())
    print(f"(w3) eager head [0, {lo}) and remainder [{hi}, {got.shape[0]}) "
          f"equal to eager: {head}, {rest}; compiled [{lo}, {hi}) vs the "
          f"one-device view: largest difference {err:.3e} [{gpu}]",
          flush=True)
    if not (head and rest) or not torch.allclose(
            got[lo:hi], single[lo:hi], rtol=W_RTOL,
            atol=W_RTOL * float(single[lo:hi].abs().max())):
        raise AssertionError("(w3) view disagrees")
    eager_bound("config2 view", "as built, the compiled midsection",
                got[lo:hi], eager[lo:hi], gpu, phase="(w3)")
    del eager, single
    offset = cp.block_samples - d * cp.block_samples // tb
    aligned = compiled_tail("config2", dev, offset).read(tb)
    if eager_bound("config2 view", "on the compiled windows (block 1)",
                   got[tb - d:2 * tb - d], aligned, gpu,
                   phase="(w3)") > 1.0:
        raise AssertionError("(w3) view disagrees with eager")
    return launches


def drive_psrfits(dev, gpu, tmp):
    """(w4): (v1)'s FRB filterbank through an 8-bit search-mode PSRFITS
    file and back onto the card, ``DMTrialSearch`` recovering the burst
    from it; the flagship ``run_fn`` profile through a fold-mode file and
    back.  Returns the launches of the two paths' runs."""
    import os
    from baseband_tasks_tpu_torch import (DispersionMeasure,
                                          EmptyStreamGenerator, SetAttribute,
                                          Time, open as bopen, units as u)
    from baseband_tasks_tpu_torch.io import psrfits
    from baseband_tasks_tpu_torch.models import DMTrialSearch
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    dispersed, power = frb_chain(dev)
    dd.reset_launch_counts()
    fb = power.read()
    torch.cuda.synchronize()
    launches = nonzero(dd.launch_counts)
    freq = np.asarray(power.frequency.to_value(u.MHz)).reshape(-1)
    order = np.argsort(freq)
    fb = fb[:, order]
    path = os.path.join(tmp, "frb.fits")
    t0 = time.perf_counter()
    with psrfits.open(path, "w", obs_mode="search", template=SetAttribute(
            power, frequency=freq[order] * u.MHz), nsblk=W_NSBLK, nbits=8,
            source="FRB") as fw:
        fw.write(fb)
    t1 = time.perf_counter()
    rh = bopen(path, device=dev)
    back = rh.read()
    t2 = time.perf_counter()
    n = back.shape[0]
    rows = fb[:n].reshape(n // W_NSBLK, W_NSBLK, -1)
    step = (rows.amax(1) - rows.amin(1)) / 255
    err = float(((back.reshape(rows.shape) - rows).abs()
                 / step[:, None]).max())
    print(f"(w4) search mode: {type(rh).__name__} {tuple(back.shape)} of "
          f"{tuple(fb.shape)} spectra on {back.device}, 8 bits, rows of "
          f"{W_NSBLK}: largest error {err:.3f} of a row's level step; "
          f"write {1e3 * (t1 - t0):.1f} ms, read {1e3 * (t2 - t1):.1f} ms "
          f"[{gpu}]", flush=True)
    if back.device != fb.device or err > 0.5 + 1e-3:
        raise AssertionError("(w4) search-mode round trip wrong")
    search = DMTrialSearch(rh.frequency, rh.sample_rate, FRB_DMS,
                           FRB_NTIME, device=dev)
    shift = (DispersionMeasure(FRB_DM).time_delay(
        search.reference_frequency, 800 * u.MHz).to_value(u.s) * FRB_RATE)
    expected_t = int((FRB_BURST + shift - dispersed.pad_start) / FRB_CHAN)
    snr, width = search.detect(back[:FRB_NTIME])
    t, j = np.unravel_index(np.argmax(snr), snr.shape)
    print(f"(w4) detect on the PSRFITS filterbank: S/N {snr[t, j]:.1f}, "
          f"boxcar {int(width[t, j])} [{gpu}]", flush=True)
    check_burst("detect (PSRFITS)", int(t), float(FRB_DMS[j]), expected_t,
                phase="(w4)")
    rh.close()
    kern = flagship(dev)
    dd.reset_launch_counts()
    prof, cnt = kern.run_fn(2)(seed=0)
    torch.cuda.synchronize()
    for k, v in nonzero(dd.launch_counts).items():
        launches[k] = launches.get(k, 0) + v
    prof = (prof / cnt.clamp_min(1)[:, None, None]).float() \
        if cnt.ndim == 1 else prof.float()
    nbin, nchan, npol = prof.shape
    fold_s = 2 * kern.global_block / kern.chan_rate.to_value(u.Hz)
    freqs = np.asarray(kern.freqs.to_value(u.MHz)).reshape(nchan, 1)
    template = SetAttribute(EmptyStreamGenerator(
        shape=(1, nbin, nchan, npol), start_time=Time.from_mjd(58000.0),
        sample_rate=u.Quantity(1 / fold_s, u.Hz), samples_per_frame=1,
        dtype=np.float32, device="cpu"), frequency=freqs * u.MHz,
        sideband=1)
    path = os.path.join(tmp, "fold.fits")
    with psrfits.open(path, "w", template=template, source="B1937+21",
                      dm=500.0) as fw:
        fw.write(prof[None])
    fr = bopen(path, device=dev)
    folded = fr.read(1)[0]
    span = (prof.amax(0) - prof.amin(0)).clamp_min(1e-30)
    ferr = float(((folded - prof).abs() / span).max())
    print(f"(w4) fold mode: {type(fr).__name__} {tuple(fr.shape)} on "
          f"{folded.device}, the flagship profile through 16 bits: largest "
          f"error {ferr:.3e} of a channel's range (one level "
          f"{1 / 65534:.3e}) [{gpu}]", flush=True)
    if ferr > 1.0 / 65534 + 1e-6 or folded.device != prof.device:
        raise AssertionError("(w4) fold-mode round trip wrong")
    fr.close()
    del kern
    return launches


def check_hdf5_coding(dev, gpu):
    """Without ``h5py``: the HDF5 bit-packed payload coding of one config
    4 block (16 complex lanes; 8, 4 and 2 bits, the writer's scale) with
    no file, its words decoded on the card by the reader's decoder
    against the reader's host decode, bit for bit."""
    from baseband_tasks_tpu_torch.io import hdf5
    from baseband_tasks_tpu_torch.ops import unpack as up
    block, _ = config4_block(dev)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((block, C4_THREADS, 2)).astype(np.float32)
    data = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    sigma = float(np.std(x))
    for bps in (8, 4, 2):
        scale = {8: 32.0, 4: 2.5, 2: 1.0}[bps] / sigma
        raw = hdf5._encode(data * scale, "bps", bps)
        host = hdf5.host_decode(raw, bps, data.dtype, data.shape, scale)
        dec = hdf5.packed_decoder(bps, data.shape[1:], True, scale)(
            torch.from_numpy(up.words_from_bytes(raw)).to(dev))
        exact = torch.equal(dec, torch.from_numpy(host).to(dev))
        print(f"(w5) {bps}-bit HDF5 payload coding of a {data.shape} "
              f"block, decoded on {dec.device} vs the host decode bit for "
              f"bit: {exact} [{gpu}]", flush=True)
        if not exact:
            raise AssertionError(f"(w5) {bps}-bit decode differs")


def drive_hdf5(dev, gpu, tmp):
    """(w5), where ``h5py`` imports: an 8-bit bps HDF5 file of config 4's
    shape (16 complex lanes at 2^18 Hz, W_BLOCKS blocks), its packed
    words decoded on the card against the host read bit for bit, then
    packed Dedisperse(29.7) -> Square over W_SHARDS shards against the
    one-device float path (the JAX test's rtol / atol).  Its launches
    count toward no kernel."""
    import os
    try:
        import h5py
        import yaml
    except ImportError as exc:
        print(f"(w5) the HDF5 file and its sharded chain not run: {exc} on "
              f"this machine", flush=True)
        check_hdf5_coding(dev, gpu)
        return
    from baseband_tasks_tpu_torch import (CompiledPipeline, Dedisperse,
                                          NoiseGenerator, SetAttribute,
                                          Square, Time, open as bopen,
                                          units as u)
    from baseband_tasks_tpu_torch.io import hdf5
    from baseband_tasks_tpu_torch.models import ShardedPipeline
    print(f"(w5) h5py {h5py.__version__}, yaml {yaml.__version__}",
          flush=True)
    block, _ = config4_block(dev)
    n = W_BLOCKS * block
    template = NoiseGenerator(shape=(n, C4_THREADS),
                              start_time=Time.from_mjd(58000.0),
                              sample_rate=C4_RATE * u.Hz,
                              samples_per_frame=8192, device="cpu")
    path = os.path.join(tmp, "c4.h5")
    rng = np.random.default_rng(11)
    with hdf5.open(path, "w", template=template, bps=8) as fw:
        for _ in range(W_BLOCKS):
            x = rng.standard_normal((block, C4_THREADS, 2)).astype(
                np.float32)
            fw.write((x[..., 0] + 1j * x[..., 1]).astype(np.complex64))
    fr = bopen(path, device=dev)
    t0 = time.perf_counter()
    host = torch.from_numpy(fr.read_host(0, n)).to(dev)
    t1 = time.perf_counter()
    words = torch.from_numpy(fr.read_packed(0, n)).to(dev)
    dec = fr.packed_decode_fn()(words)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    exact = torch.equal(dec, host)
    print(f"(w5) {type(fr).__name__} {fr.encoding} {fr.bps}-bit "
          f"{tuple(fr.shape)}: read_packed + decode on the card vs the host "
          f"read bit for bit: {exact}; host read {1e3 * (t1 - t0):.1f} ms, "
          f"packed read + decode {1e3 * (t2 - t1):.1f} ms [{gpu}]",
          flush=True)
    if not exact:
        raise AssertionError("(w5) HDF5 packed decode differs")
    del host, words, dec
    tail = Square(Dedisperse(SetAttribute(fr, frequency=config4_freq(u),
                                          sideband=1),
                             C4_DM, samples_per_frame=block))
    cp_p = CompiledPipeline(tail, block_samples=block, packed=True)
    cp_f = CompiledPipeline(tail, block_samples=block)
    w_check_pads("(w5)", "hdf5 packed", cp_p)
    ref = cp_f.run_blocks(cp_f.read_source_blocks(W_BLOCKS))
    got = ShardedPipeline(cp_p, virtual_mesh(dev, W_SHARDS, 1)).run_blocks(
        cp_p.read_source_blocks(W_BLOCKS))
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ok = torch.allclose(got, ref, rtol=W_HDF5_RTOL, atol=W_HDF5_ATOL)
    print(f"(w5) packed Dedisperse({C4_DM}, {tail.ih.engine!r}) -> Square "
          f"over {W_SHARDS} shards vs the one-device float path: "
          f"{tuple(got.shape)}, largest difference {err:.3e} (rtol "
          f"{W_HDF5_RTOL}, atol {W_HDF5_ATOL}: {ok}) [{gpu}]", flush=True)
    if not ok:
        raise AssertionError("(w5) packed sharded chain disagrees")
    fr.close()


def drive_sharded_and_stored(dev, gpu):
    """Phase (w).  Returns the launch counts of (w1)-(w4), and (w1)'s
    launches, ms a block and output digests for phase (x)."""
    import tempfile
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    full_fp32()
    w1 = drive_sharded_compiled("config2", dev, gpu, "(w1)")
    add(w1[0])
    torch.cuda.empty_cache()
    add(drive_sharded_compiled("config3_quad", dev, gpu, "(w2)")[0])
    torch.cuda.empty_cache()
    add(drive_sharded_view(dev, gpu))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        add(drive_psrfits(dev, gpu, tmp))
        torch.cuda.empty_cache()
        drive_hdf5(dev, gpu, tmp)
    torch.cuda.empty_cache()
    return launches, w1

# -- two processes on the one card: phase (x) -------------------------------

X_WORLD = 2                  # processes, each with 2 virtual shards of cuda:0
X_TIMEOUT = 300              # seconds for the pair of workers
X_TURNS = 4                  # timed turns (best of)
# the transport's kinds of counters, saved by the workers
X_TRANSFER = ("calls", "bytes")


def _counts_arrays(counts):
    names = sorted(k for k, v in counts.items() if v)
    return np.asarray(names), np.asarray([counts[k] for k in names])


def _counts_dict(results, key):
    return {str(k): int(v) for k, v in zip(results[f"{key}/names"],
                                           results[f"{key}/counts"])}


def _x_turns(fn, per):
    """Best host ms of ``fn`` over X_TURNS synchronised calls, divided by
    ``per``, and the transport's counters a call, divided by ``per``."""
    from baseband_tasks_tpu_torch.parallel import _transport as tr
    tr.reset_transfer_counts()
    best = min(host_s(fn, turns=1) for _ in range(X_TURNS))
    return 1e3 * best / per, np.asarray(
        [tr.transfer_counts[k] / (X_TURNS * per) for k in X_TRANSFER])


def _x_profile(out, key, fn, per):
    """This process's wall and device-busy ms of one profiled call of
    ``fn`` over ``per`` steps or blocks, and its top device rows."""
    wall, busy, rows = device_profile(fn)
    out[f"{key}/profile"] = np.asarray([wall / per, busy / per])
    out[f"{key}/rows"] = np.asarray([r[2][:60] for r in rows[:5]])
    out[f"{key}/rows_ms"] = np.asarray([r[0] / 1e3 / per for r in rows[:5]])
    out[f"{key}/halo_ms"] = np.float64(sum(r[0] for r in rows
                                           if "halo" in r[2]) / 1e3 / per)


def _x_print_profile(tag, z, key, unit, gpu):
    wall, busy = z[f"{key}/profile"]
    print(f"{tag} profiled: {wall:.3f} ms a {unit} wall, this process's "
          f"device work {busy:.3f} ({busy / wall:.2f}) [{gpu}]", flush=True)
    for name, ms in zip(z[f"{key}/rows"], z[f"{key}/rows_ms"]):
        print(f"{tag}   {ms:8.3f} ms/{unit}  {name} [{gpu}]", flush=True)


def multihost_worker_checks(ctx):
    """Phase (x) inside one of the two worker processes (started by
    :func:`drive_multihost` through ``multihost_check``): the paths over
    a mesh whose shards are split between the processes, counted and
    timed; rank 0 also runs the searches on a one-process mesh.  Returns
    the arrays the driver compares."""
    import hashlib
    from baseband_tasks_tpu_torch import CompiledPipeline, FastFoldingSearch
    from baseband_tasks_tpu_torch.models import (DMTrialSearch, RMSynthesis,
                                                 ShardedPipeline)
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.parallel import Mesh
    from baseband_tasks_tpu_torch import units as u
    full_fp32()
    dev = torch.device(ctx.devices[0])
    out = {"world": np.int64(ctx.world)}

    # (x1) the flagship's packed run_fn on (4, 1), 2 + 2 shards
    pipe = flagship(None, mesh=ctx.mesh(N_SHARDS, 1))
    run = pipe.run_fn(N_ITER, ingest_bits=8)
    dd.reset_launch_counts()
    prof, cnt = run(seed=0)
    torch.cuda.synchronize()
    out["x1/names"], out["x1/counts"] = _counts_arrays(dd.launch_counts)
    out["x1/prof"], out["x1/cnt"] = prof.cpu().numpy(), cnt.cpu().numpy()
    out["x1/global_block"] = np.int64(pipe.global_block)
    out["x1/ms"], out["x1/transfer"] = _x_turns(
        functools.partial(run, seed=0), N_ITER)
    _x_profile(out, "x1", functools.partial(run, seed=0), N_ITER)
    del pipe, run

    # step_fn on (2, 2), 2 + 2 shards, against one process on the card
    mesh = ctx.mesh(2, 2)
    step = flagship(None, mesh=mesh)
    T = step.global_block
    (xf,) = randn(dev, (T, 64, 2, 2), 72, count=1)
    row = step.fold_model.foldv(3 * T, T)
    got = step.step_fn()(xf, row)
    out["x1s/prof"], out["x1s/cnt"] = (t.cpu().numpy() for t in got)
    if ctx.rank == 0:
        ref = flagship(None, mesh=ctx.local_mesh(mesh)).step_fn()(xf, row)
        out["x1s/ref_prof"], out["x1s/ref_cnt"] = (t.cpu().numpy()
                                                   for t in ref)
    del step, xf, got
    torch.cuda.empty_cache()
    x4_worker(ctx, dev, out)

    # (x2) config 2 through ShardedPipeline, S = 4 over the processes
    cp = CompiledPipeline(compiled_tail("config2", dev,
                                        n_samples=W_SOURCE["config2"]))
    mesh = ctx.mesh(W_SHARDS, 1)
    sp = ShardedPipeline(cp, mesh)
    blocks = cp.read_source_blocks(W_BLOCKS)
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    mine = sp.run_blocks(blocks)
    torch.cuda.synchronize()
    out["x2/names"], out["x2/counts"] = _counts_arrays(dd.launch_counts)
    local = [i for i in range(W_SHARDS) if mesh.process_ids[i, 0] ==
             ctx.rank]
    out["x2/blocks"] = np.asarray([k + i for k in range(0, W_BLOCKS,
                                                        W_SHARDS)
                                   for i in local])
    host = mine.cpu().numpy()
    tb = cp.tail_block
    out["x2/digests"] = np.stack([np.frombuffer(hashlib.sha256(
        host[k:k + tb].tobytes()).digest(), np.uint8)
        for k in range(0, host.shape[0], tb)])
    out["x2/finite"] = np.int64(bool(np.isfinite(host.view(
        np.float32)).all()))
    del mine, host
    out["x2/ms"], out["x2/transfer"] = _x_turns(
        lambda: sp.run_blocks(blocks), W_BLOCKS)
    _x_profile(out, "x2", lambda: sp.run_blocks(blocks), W_BLOCKS)
    del cp, sp, blocks
    torch.cuda.empty_cache()

    # (x3) the sharded searches, 2 + 2 shards, against one process
    x = search_series(dev)
    rows = torch.stack([x] + randn(dev, (SEARCH_N,), 75, count=3))
    freq = (800 + (np.arange(FRB_CHAN) - FRB_CHAN / 2)
            * (FRB_RATE / FRB_CHAN / 1e6)) * u.MHz
    g = torch.Generator(device=dev).manual_seed(76)
    power = torch.randn((FRB_NTIME, FRB_CHAN), generator=g,
                        device=dev) ** 2
    q, u_ = torch.randn((2, RM_BATCH, RM_CHAN), generator=g, device=dev)
    cases = {
        "accel": (lambda: accel_search(dev, "pallas"), "z",
                  lambda s, m: s.search_sharded(x, m)),
        "ffa": (lambda: FastFoldingSearch(FFA_BASE, SEARCH_N, device=dev),
                "batch", lambda s, m: s.snr_sharded(rows, m)),
        "dm": (lambda: DMTrialSearch(freq, FRB_RATE / FRB_CHAN * u.Hz,
                                     FRB_DMS, FRB_NTIME, device=dev), "dm",
               lambda s, m: s.search_sharded(power, m)),
        "rm": (lambda: RMSynthesis((1200 + 0.25 * np.arange(RM_CHAN))
                                   * u.MHz, np.linspace(-500, 500, RM_PHI),
                                   device=dev), "phi",
               lambda s, m: s.fdf_sharded(q, u_, m)),
    }
    for name, (make, axis, call) in cases.items():
        model, mesh = make(), ctx.axis_mesh(axis, N_SHARDS)
        call(model, mesh)                   # the shards' tables, once
        torch.cuda.synchronize()
        dd.reset_launch_counts()
        got = call(model, mesh)
        torch.cuda.synchronize()
        out[f"x3/{name}/names"], out[f"x3/{name}/counts"] = \
            _counts_arrays(dd.launch_counts)
        out[f"x3/{name}/ms"], _ = _x_turns(lambda: call(model, mesh), 1)
        if ctx.rank == 0:
            ref = call(make(), ctx.local_mesh(mesh))
            diff = (got - ref).abs()
            out[f"x3/{name}/err"] = np.float64(
                float(diff.max()) / max(float(ref.abs().max()), 1e-30))
            out[f"x3/{name}/same"] = np.int64(bool(torch.equal(got, ref)))
            out[f"x3/{name}/shape"] = np.asarray(got.shape)
        del model, got
        torch.cuda.empty_cache()
    return out


def _local_same_edges(a, b, cells):
    """This process's cells' (front, end) buffers bit-identical."""
    return all(torch.equal(x[cell], y[cell]) for x, y in zip(a, b)
               for cell in cells)


def x4_worker(ctx, dev, out):
    """Phase (x4) in a worker: ``halo='remote'`` across the two
    processes, the ``halo_remote`` kernel's push form writing the edges
    into the other process's memory through CUDA IPC.  The remote_*
    cases of ``multihost_check`` (small shapes, against one process and
    'ppermute'); the float ``run_fn`` at full width on (4, 1), 2 + 2,
    its edges against 'ppermute', counted, timed and profiled, with the
    transport's bytes a step; ``step_fn`` on (2, 2) against 'ppermute'
    and (rank 0) one process."""
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.parallel import _transport as tr
    from baseband_tasks_tpu_torch.tools import multihost_check as mc
    mc.remote_cases(ctx, out, mc.remote_meshes(ctx))
    mesh = ctx.mesh(N_SHARDS, 1)
    pipes = {h: flagship(None, mesh=mesh, halo=h)
             for h in ("remote", "ppermute")}
    runs = {h: p.run_fn(N_ITER) for h, p in pipes.items()}
    cells = mesh.local_cells()
    shape = (pipes["remote"].global_block, 64, 2)
    planes = [shard_grid(b, mesh)
              for b in pipes["remote"]._payload(0, shape, None)]
    # every process makes every exchange (no short cut on a mismatch)
    same = [_local_same_edges(pipes["remote"]._halo_edges(p),
                              pipes["ppermute"]._halo_edges(p), cells)
            for p in planes]
    out["x4/edges_same"] = np.int64(all(same))
    del planes
    for run in runs.values():
        run(seed=0)                     # the payload, made once per seed
    torch.cuda.synchronize()
    dd.reset_launch_counts()
    tr.reset_transfer_counts()
    prof, cnt = runs["remote"](seed=0)
    torch.cuda.synchronize()
    out["x4/names"], out["x4/counts"] = _counts_arrays(dd.launch_counts)
    out["x4/transfer"] = np.asarray([tr.transfer_counts[k] / N_ITER
                                     for k in X_TRANSFER])
    pipe = pipes["remote"]
    # what the profiles' gather sends a step: each local cell's profile
    # and int32 counts to the other process
    out["x4/profile_bytes"] = np.int64(len(cells) * pipe.n_phase * (
        pipe._c_local * pipe.n_pol + 1) * 4 * (ctx.world - 1))
    # the least bytes of this process's edges a step: each output written
    # once, each neighbour row it copies read once (two planes)
    n = mesh.devices.shape[0]
    rows = sum(pipe.pad_start + pipe.pad_end + pipe.pad_start * (t > 0)
               + pipe.pad_end * (t < n - 1) for t, _ in cells)
    out["x4/halo_bound_ms"] = np.float64(
        1e3 * 2 * rows * pipe._c_local * pipe.n_pol * 4 / HBM_BYTES_PER_S)
    out["x4/prof"], out["x4/cnt"] = prof.cpu().numpy(), cnt.cpu().numpy()
    out["x4/global_block"] = np.int64(pipe.global_block)
    pp = runs["ppermute"](seed=0)
    out["x4/pp_prof"], out["x4/pp_cnt"] = (t.cpu().numpy() for t in pp)
    for h in ("remote", "ppermute", "ppermute", "remote"):
        ms, transfer = _x_turns(functools.partial(runs[h], seed=0), N_ITER)
        key = f"x4/{h}_ms"
        out[key] = np.float64(min(ms, out.get(key, np.inf)))
        out[f"x4/{h}_transfer"] = transfer
    _x_profile(out, "x4", functools.partial(runs["remote"], seed=0), N_ITER)
    for p in pipes.values():
        p.close()
    del pipes, runs, prof, cnt, pp
    torch.cuda.empty_cache()

    # step_fn on (2, 2): each time ring crosses the processes
    mesh = ctx.mesh(2, 2)
    steps = {h: flagship(None, mesh=mesh, halo=h)
             for h in ("remote", "ppermute")}
    T = steps["remote"].global_block
    (xf,) = randn(dev, (T, 64, 2, 2), 72, count=1)
    row = steps["remote"].fold_model.foldv(3 * T, T)
    dd.reset_launch_counts()
    a = steps["remote"].step_fn()(xf, row)
    torch.cuda.synchronize()
    out["x4s/names"], out["x4s/counts"] = _counts_arrays(dd.launch_counts)
    b = steps["ppermute"].step_fn()(xf, row)
    out["x4s/same"] = np.int64(torch.equal(a[0], b[0])
                               and torch.equal(a[1], b[1]))
    out["x4s/prof"], out["x4s/cnt"] = (t.cpu().numpy() for t in a)
    for p in steps.values():
        p.close()
    if ctx.rank == 0:
        ref = flagship(None, mesh=ctx.local_mesh(mesh),
                       halo="remote").step_fn()(xf, row)
        out["x4s/ref_prof"], out["x4s/ref_cnt"] = (t.cpu().numpy()
                                                   for t in ref)
    del steps, xf, a, b
    torch.cuda.empty_cache()


#: the remote_* cases of multihost_check, run by the (x4) workers
X4_CASES = [f"remote_{p}_{m}" for m in ("line", "grid", "chan", "mixed")
            for p in ("open", "periodic")]


def check_x4(res, gpu, q_refs):
    """Phase (x4)'s results from the two workers: the small remote_*
    cases bit for bit against one process and 'ppermute'; the full-width
    float ``run_fn`` with halo='remote' (edges bit for bit against
    'ppermute', launches exact, profiles within PROFILE_RTOL of (q)'s
    one-process 'remote' run and of 'ppermute', no edge bytes through
    the transport), timed beside 'ppermute' in the same workers, (x1) and
    (q); ``step_fn`` on (2, 2) against 'ppermute' and one process.
    Returns the launches of the run and the step, both processes
    summed."""
    launches = {}
    z = res[0]
    for case in X4_CASES:
        multi = z[f"{case}/multi"]
        same_one = bool(np.array_equal(multi, z[f"{case}/one"]))
        same_pp = bool(np.array_equal(multi, z[f"{case}/ppermute"]))
        counts = [int(zr[f"{case}/launches"]) for zr in res]
        print(f"(x4) {case}: {multi.size} values, against one process "
              f"{'bit-identical' if same_one else 'DIFFERS'}, against "
              f"'ppermute' {'bit-identical' if same_pp else 'DIFFERS'}; "
              f"halo_remote launches {counts}", flush=True)
        if not (same_one and same_pp):
            raise AssertionError(f"(x4) {case} differs")
    want = {"k1_float": N_ITER * N_SHARDS // X_WORLD,
            "k2": N_ITER * N_SHARDS // X_WORLD,
            "k3_fold": N_ITER * N_SHARDS // X_WORLD,
            # two planes a step, each a push and a copy out
            "halo_remote": N_ITER * 2 * 2}
    ref_prof, ref_cnt = q_refs["remote"]
    busy = []
    for r, z in enumerate(res):
        counts = _counts_dict(z, "x4")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"(x4) rank {r}: float run_fn({N_ITER}) halo='remote' on 4x1 "
              f"(2 + 2 shards): launches {counts}; edges bit-identical to "
              f"'ppermute': {bool(z['x4/edges_same'])}", flush=True)
        if counts != want or not z["x4/edges_same"]:
            raise AssertionError(f"(x4) rank {r}: launches (want {want}) "
                                 f"or edges")
        got = (torch.from_numpy(z["x4/prof"]), torch.from_numpy(z["x4/cnt"]))
        total = int(got[1].sum())
        if total != N_ITER * int(z["x4/global_block"]):
            raise AssertionError(f"(x4) rank {r}: counts sum {total}")
        check_profile(f"rank {r} against (q)'s one-process 4x1 'remote' "
                      f"run", got, (ref_prof, ref_cnt), False, gpu, "(x4)")
        check_profile(f"rank {r} 'remote' against 'ppermute' in the same "
                      f"workers", got, (torch.from_numpy(z["x4/pp_prof"]),
                                        torch.from_numpy(z["x4/pp_cnt"])),
                      False, gpu, "(x4)")
        calls, nbytes = z["x4/transfer"]
        pp_calls, pp_bytes = z["x4/ppermute_transfer"]
        print(f"(x4) rank {r}: the transport a step: {calls:.2f} calls, "
              f"{nbytes:.0f} B sent (the profiles' gather: "
              f"{int(z['x4/profile_bytes'])} B); 'ppermute' "
              f"{pp_calls:.2f} calls, {pp_bytes / 1e6:.3f} MB", flush=True)
        if nbytes != int(z["x4/profile_bytes"]):
            raise AssertionError(f"(x4) rank {r}: the transport carried "
                                 f"{nbytes} B a step, not only the profiles")
        x1_ms = float(z["x1/ms"])
        print(f"(x4) rank {r}: {z['x4/remote_ms']:.3f} ms a float step "
              f"across two processes with halo='remote', "
              f"{z['x4/ppermute_ms']:.3f} with 'ppermute' (same workers), "
              f"(x1)'s packed 'ppermute' {x1_ms:.3f}, (q)'s one-process "
              f"'remote' {q_refs['remote_ms']:.3f} "
              f"({z['x4/remote_ms'] / q_refs['remote_ms']:.2f}x) [{gpu}]",
              flush=True)
        _x_print_profile(f"(x4) rank {r}", z, "x4", "step", gpu)
        print(f"(x4) rank {r}: halo_remote's push form and copy out "
              f"{z['x4/halo_ms']:.4f} ms a step of device time (profiled, 4 "
              f"launches), bound {z['x4/halo_bound_ms']:.4f} ms (bytes) "
              f"[{gpu}]", flush=True)
        busy.append(z["x4/profile"])
    wall = max(b[0] for b in busy)
    work = sum(b[1] for b in busy)
    print(f"(x4) the card: both processes' device work {work:.3f} ms of a "
          f"{wall:.3f} ms profiled step, idle share {1 - work / wall:.2f} "
          f"[{gpu}]", flush=True)
    for r, z in enumerate(res):
        counts = _counts_dict(z, "x4s")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"(x4) rank {r}: step_fn halo='remote' on 2x2 (2 + 2 "
              f"shards): launches {counts}; bit-identical to 'ppermute': "
              f"{bool(z['x4s/same'])}", flush=True)
        if counts.get("halo_remote") != 2 or not z["x4s/same"]:
            raise AssertionError(f"(x4) rank {r}: step_fn remote")
    z = res[0]
    check_profile("step_fn 'remote' on 2x2 (2 + 2 shards) against one "
                  "process", tuple(torch.from_numpy(z[k]) for k in (
                      "x4s/prof", "x4s/cnt")),
                  tuple(torch.from_numpy(z[k]) for k in (
                      "x4s/ref_prof", "x4s/ref_cnt")), False, gpu, "(x4)")
    return launches


def drive_multihost(dev, gpu, q_refs, w1):
    """Phase (x): two worker processes on the card, each with 2 virtual
    shards of it, over gloo (NCCL refuses two ranks on one card), running
    :func:`multihost_worker_checks`; their results held against (q)'s
    (4, 1) run and (w1)'s sharded output from this process.  Returns the
    launch counts of both processes summed."""
    import os
    import subprocess
    import tempfile
    from baseband_tasks_tpu_torch.tools import multihost_check as mc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "x.npz")
        cmd = [sys.executable, "-m",
               "baseband_tasks_tpu_torch.tools.multihost_check", None,
               str(X_WORLD), f"file://{tmp}/rendezvous", out,
               "chip_smoke:multihost_worker_checks",
               ",".join([str(dev)] * 2), "--backend", "gloo"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd[:3] + [str(r)] + cmd[4:], cwd=root,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(X_WORLD)]
        try:
            texts = [p.communicate(timeout=X_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, texts)):
            tail = "\n".join(text.strip().splitlines()[-40:])
            print(f"(x) worker {r}: exit {p.returncode} after {wall:.1f} s; "
                  f"its output's end:\n{tail}", flush=True)
            if p.returncode != 0:
                raise AssertionError(f"(x) worker {r} failed")
        res = [dict(np.load(mc.rank_file(out, r))) for r in range(X_WORLD)]
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (x1)
    want = {k: N_ITER * N_SHARDS // X_WORLD
            for k in ("k1_packed", "k2", "k3_fold")}
    ref_prof, ref_cnt = q_refs["run"]
    for r, z in enumerate(res):
        counts = _counts_dict(z, "x1")
        add(counts)
        print(f"(x1) rank {r}: run_fn({N_ITER}, ingest_bits=8) on 4x1 "
              f"(2 + 2 shards): launches {counts}", flush=True)
        if counts != want:
            raise AssertionError(f"(x1) rank {r}: launches, want {want}")
        got = (torch.from_numpy(z["x1/prof"]), torch.from_numpy(z["x1/cnt"]))
        total = int(got[1].sum())
        if total != N_ITER * int(z["x1/global_block"]):
            raise AssertionError(f"(x1) rank {r}: counts sum {total}")
        check_profile(f"rank {r} against (q)'s one-process 4x1 run", got,
                      (ref_prof, ref_cnt), False, gpu, "(x1)")
        calls, nbytes = z["x1/transfer"]
        print(f"(x1) rank {r}: {z['x1/ms']:.3f} ms a step across two "
              f"processes against (q)'s {q_refs['ms']:.3f} one-process "
              f"({z['x1/ms'] / q_refs['ms']:.2f}x); the transport "
              f"{calls:.1f} calls, {nbytes / 1e6:.3f} MB sent a step "
              f"[{gpu}]", flush=True)
        _x_print_profile(f"(x1) rank {r}", z, "x1", "step", gpu)
    z = res[0]
    a = tuple(torch.from_numpy(z[k]) for k in ("x1s/prof", "x1s/cnt"))
    b = tuple(torch.from_numpy(z[k]) for k in ("x1s/ref_prof",
                                                "x1s/ref_cnt"))
    for r in range(1, X_WORLD):
        other = (torch.from_numpy(res[r]["x1s/prof"]),
                 torch.from_numpy(res[r]["x1s/cnt"]))
        if not (torch.equal(other[0], a[0]) and torch.equal(other[1], a[1])):
            raise AssertionError(f"(x1) step_fn: rank {r} holds another "
                                 f"result than rank 0")
    check_profile("step_fn on 2x2 (2 + 2 shards) against one process", a,
                  b, False, gpu, "(x1)")
    x4_launches = check_x4(res, gpu, q_refs)
    add(x4_launches)

    # (x2)
    w1_counts, w1_ms, w1_digests = w1
    summed = {}
    for r, z in enumerate(res):
        counts = _counts_dict(z, "x2")
        add(counts)
        for k, v in counts.items():
            summed[k] = summed.get(k, 0) + v
        same = [bytes(d) == w1_digests[int(k)]
                for d, k in zip(z["x2/digests"], z["x2/blocks"])]
        print(f"(x2) rank {r}: blocks {z['x2/blocks'].tolist()} of config "
              f"2 through ShardedPipeline (S = {W_SHARDS} over "
              f"{X_WORLD} processes): bit for bit with (w1)'s one-process "
              f"output {sum(same)} of {len(same)}, finite "
              f"{bool(z['x2/finite'])}; launches {counts}", flush=True)
        if not all(same) or not z["x2/finite"]:
            raise AssertionError(f"(x2) rank {r}: output differs from (w1)")
    covered = sorted(int(k) for z in res for k in z["x2/blocks"])
    print(f"(x2) launches of both processes {summed}, (w1)'s {w1_counts}",
          flush=True)
    if covered != list(range(W_BLOCKS)) or summed != w1_counts:
        raise AssertionError("(x2) blocks or launches differ from (w1)")
    for r, z in enumerate(res):
        calls, nbytes = z["x2/transfer"]
        print(f"(x2) rank {r}: {z['x2/ms']:.3f} ms a block across two "
              f"processes against (w1)'s {w1_ms:.3f} one-process "
              f"({z['x2/ms'] / w1_ms:.2f}x); the transport {calls:.2f} "
              f"calls, {nbytes / 1e6:.3f} MB sent a block [{gpu}]",
              flush=True)
        _x_print_profile(f"(x2) rank {r}", z, "x2", "block", gpu)

    # (x3)
    tols = {"accel": FFT_TOL, "ffa": 1e-4, "dm": SEARCH_TOL,
            "rm": SEARCH_TOL}
    for name, tol in tols.items():
        for r, z in enumerate(res):
            add(_counts_dict(z, f"x3/{name}"))
        z = res[0]
        err, same = float(z[f"x3/{name}/err"]), bool(z[f"x3/{name}/same"])
        ms = [float(zr[f"x3/{name}/ms"]) for zr in res]
        shape = tuple(z[f"x3/{name}/shape"].tolist())
        print(f"(x3) {name} {shape} over 2 + 2 shards: vs one process "
              f"{err:.3e} of the peak "
              f"({'bit-identical' if same else 'not bit-identical'}); "
              f"launches {[_counts_dict(zr, f'x3/{name}') for zr in res]}; "
              f"{min(ms):.3f} ms a call [{gpu}]", flush=True)
        if err > tol:
            raise AssertionError(f"(x3) {name} disagrees with one process")
    if launches.get("accel_corr", 0) != N_SHARDS:
        raise AssertionError(f"(x3) accel_corr launched "
                             f"{launches.get('accel_corr', 0)} times, want "
                             f"{N_SHARDS} (one a shard)")
    print(f"(x) two processes on one card: {wall:.1f} s of workers, "
          f"launches {launches}", flush=True)
    return launches


# -- the LOFAR correlator node: phase (y) ----------------------------------

LOFAR_SEED = 2 ** 31 + 28
LOFAR_LIMIT = 4e-5    # the node's vis_rel_err and auto_rel_err limits


def vis_gap(got, want):
    """The LOFAR node's measure of full-polarization visibility sums
    ``(n_seg, n_baseline, ..., 4)``: the largest gap over sqrt(V_ii^pp
    V_jj^qq) of its cell, the autocorrelations those of ``want``."""
    n = int(round((np.sqrt(8 * want.shape[1] + 1) - 1) / 2))
    i, j = np.triu_indices(n)
    auto = np.cumsum([0] + [n - k for k in range(n - 1)])
    power = want[:, auto].abs()[..., [0, 3]]           # (S, n, ..., 2)
    pi = power[:, i].repeat_interleave(2, dim=-1)       # p of XX XY YX YY
    pj = power[:, j].repeat(*(1,) * (power.ndim - 1), 2)
    return float(((got - want).abs() / (pi * pj).sqrt()).max())


def drive_lofar(dev, gpu):
    """Phase (y) (module docstring): ``xcorr`` at the LOFAR node's full
    width on a block's stack as the node's chain gives it, then one dump
    through ``run_fn``.  Returns (the kernels line's ``xcorr`` result,
    the dump's ``xcorr`` launches)."""
    from benchmark import harness
    from baseband_tasks_tpu_torch.models.compiled import (
        _concat_window, init_reduction_acc, make_reduction_update)
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    from baseband_tasks_tpu_torch.ops.xcorr import (xcorr_accumulate,
                                                    xcorr_accumulate_ref)
    system = harness.module("systems", "lofar_hba_cobalt")
    cfg = harness.config_of(harness.load_spec(), "lofar_hba_cobalt")
    traffic = dict(harness.traffic_of("dump_1s"), pool=1)
    feed = system.make_feed(cfg, traffic, LOFAR_SEED, dev, harness.Spans())
    cp, blocks = feed.cp, feed.blocks[0]
    n_blocks = system.dump_blocks(cfg)[1]
    ids, n_seg = cp.segment_ids_np(n_blocks)
    seg = torch.as_tensor(ids[0], device=dev)
    _, x = cp._step(_concat_window, tail=False)(cp.init_carry(),
                                                 cp._block(blocks, 0))
    zeros = init_reduction_acc(cp.reduction, cp._tail.sample_shape, n_seg,
                               dev)[0]
    print(f"(y) LOFAR block stack {tuple(x.shape)} strides {x.stride()}, "
          f"segment ids {sorted(set(ids[0].tolist()))} (trash {n_seg}), "
          f"sums {tuple(zeros.shape)}, x_form {cp.x_form!r}", flush=True)
    dd.reset_launch_counts()
    got = xcorr_accumulate(x, seg, zeros.clone(), full=True)
    again = xcorr_accumulate(x, seg, zeros.clone(), full=True)
    torch.cuda.synchronize()
    n_launch = dd.launch_counts["xcorr"]
    want = xcorr_accumulate_ref(x, seg, zeros.clone(), full=True)
    xb = torch.complex(x.real.to(torch.bfloat16).float(),
                       x.imag.to(torch.bfloat16).float())
    control = xcorr_accumulate_ref(xb, seg, zeros.clone(), full=True)
    del xb
    counts = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    node, update = cp.stages[-1].node, make_reduction_update(cp.reduction)
    unfused = zeros.clone()
    update(unfused, counts, node.task(x), seg)
    gap = vis_gap(got[:n_seg], want[:n_seg])
    gap_u = vis_gap(got[:n_seg], unfused[:n_seg])
    ctl = vis_gap(control[:n_seg], want[:n_seg])
    err = float((got - want).abs().max())
    same = torch.equal(got, again)
    trash = torch.equal(got[n_seg], zeros[n_seg])
    print(f"(y) xcorr at the LOFAR width: launches {n_launch}, gap {gap:.3e} "
          f"to the plain version, {gap_u:.3e} to the unfused path (limit "
          f"{LOFAR_LIMIT:g}; the bf16 control {ctl:.3e}), max abs err "
          f"{err:.3e}, {'bit for bit' if same else 'DIFFERS'} from call to "
          f"call, trash row {'untouched' if trash else 'WRITTEN'} [{gpu}]",
          flush=True)
    if (n_launch != 2 or not same or not trash or cp.x_form != "fused"
            or not gap_u <= LOFAR_LIMIT or not gap <= LOFAR_LIMIT < ctl):
        raise AssertionError("xcorr disagrees with its plain version at the "
                             "LOFAR width")
    del got, again, want, control, unfused
    sums = zeros.clone()
    ms = cuda_ms(lambda: xcorr_accumulate(x, seg, sums, full=True))
    plain_ms = cuda_ms(lambda: xcorr_accumulate_ref(x, seg, sums, full=True),
                       reps=5)
    lib_ms = cuda_ms(lambda: update(sums, counts, node.task(x), seg), reps=5)
    nb, cells = sums.shape[1], sums[0, 0].numel() // 4
    res = result(err, ms, plain_ms,
                 ((x, sums[0]), (sums[0],), 8 * nb * 4 * cells * x.shape[0]),
                 lib_ms)
    print(f"(y) xcorr: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          f"{lib_ms:.4f} ms unfused (gathers, products, index_add_), bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}): "
          f"{100 * res['bound_ms'] / ms:.1f} % [{gpu}]", flush=True)
    del sums, counts, x, zeros
    torch.cuda.empty_cache()
    run = cp.run_fn(n_blocks)
    dd.reset_launch_counts()
    vis, cnt = run(blocks)
    torch.cuda.synchronize()
    launched = {k: v for k, v in dd.launch_counts.items() if v}
    with dd.plain_versions():
        pvis, pcnt = run(blocks)
    torch.cuda.synchronize()
    gap = vis_gap(vis, pvis)
    print(f"(y) LOFAR dump through run_fn({n_blocks}): launches {launched}, "
          f"counts {cnt.tolist()}, gap to the plain versions' run {gap:.3e} "
          f"(limit {LOFAR_LIMIT:g}) [{gpu}]", flush=True)
    if (launched != {"xcorr": n_blocks} or not torch.equal(cnt, pcnt)
            or not gap <= LOFAR_LIMIT):
        raise AssertionError("the LOFAR dump disagrees with its plain run")
    del vis, cnt, pvis, pcnt
    dt = host_s(lambda: run(blocks), turns=3)
    print(f"(y) LOFAR dump: {1e3 * dt:.1f} ms, "
          f"{feed.samples_per_unit / dt:.4e} samples/s (host clock, "
          f"synchronized) [{gpu}]", flush=True)
    feed.release()
    feed.close()
    return {"xcorr": res}, n_blocks


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from baseband_tasks_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths, log = _build.build()
    print(f"build: {[p.name for p in paths]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill",
                                   "wgmma")):
            print(f"  {line.strip()}")
    gpu = gpu_line()
    full_fp32()
    dev = torch.device("cuda", 0)
    kern = flagship(dev)
    print(f"flagship: N={kern._n_fft} pads=({kern.pad_start}, "
          f"{kern.pad_end}) block={kern.block_samples} L="
          f"{kern.n_chan * kern.n_pol}", flush=True)
    results = check_kernels(kern, gpu)
    launches = drive_main_path(kern)
    time_steps(kern, gpu)
    results.update(check_variant_kernels(kern, gpu))
    del kern
    results.update(check_guppi_kernels(dev, gpu))
    torch.cuda.empty_cache()
    results.update(check_four_step(dev, gpu))
    task_launches, task_kern, task_plain = drive_task_paths(dev, gpu)
    frame = time_task_frame(task_kern, task_plain, gpu)
    del task_kern, task_plain
    print(f"(e) k2 launches on the task paths: {task_launches['k2']}")
    launches.update({k: task_launches[k] for k in KERNELS
                     if k not in FLAGSHIP})
    results.update(check_compiled_kernels(dev, gpu))
    torch.cuda.empty_cache()
    compiled = drive_compiled_paths(dev, gpu, 1e3 * frame["kernels"])
    for k in ("k1_stream", "lane_mix", "pfb_fwd", "pfb_fwd_dft"):
        launches[k] = compiled[k]
    print(f"(h) k2 / k3_trim launches on the compiled paths: "
          f"{compiled['k2']} / {compiled['k3_trim']}")
    torch.cuda.empty_cache()
    variants = drive_variants(dev, gpu)
    for k in VARIANTS:
        launches[k] = variants[k]
    torch.cuda.empty_cache()
    for k, v in drive_guppi(dev, gpu).items():
        launches[k] += v
    torch.cuda.empty_cache()
    results.update(check_search_kernels(dev, gpu))
    torch.cuda.empty_cache()
    search = drive_search(dev, gpu)
    for k in ("bank_power", "accel_corr"):
        launches[k] = search[k]
    torch.cuda.empty_cache()
    launches["resident"] = drive_resident(dev, gpu)
    torch.cuda.empty_cache()
    pipe = flagship(dev)
    results.update(check_bf16_kernels(pipe, gpu))
    bf16 = drive_bf16_ops(pipe, gpu)
    for k in BF16_KERNELS:
        launches[k] = bf16[k]
    del pipe
    torch.cuda.empty_cache()
    drive_config1(dev, gpu)
    torch.cuda.empty_cache()
    drive_masked_fold(dev, gpu)
    torch.cuda.empty_cache()
    results.update(check_halo_kernel(dev, gpu))
    torch.cuda.empty_cache()
    sharded, q_refs = drive_sharded(dev, gpu)
    launches["halo_remote"] = sharded["halo_remote"]
    torch.cuda.empty_cache()
    drive_fx(dev, gpu)
    resample = drive_resample(dev, gpu)
    print(f"(s) launches on the resample paths: {resample}", flush=True)
    for k, v in resample.items():
        launches[k] += v
    torch.cuda.empty_cache()
    drive_incoherent(dev, gpu)
    torch.cuda.empty_cache()
    config4 = drive_config4(dev, gpu)
    print(f"(u) launches on the config 4 paths: {config4}", flush=True)
    for k, v in config4.items():
        launches[k] += v
    torch.cuda.empty_cache()
    analysis = drive_analysis(dev, gpu)
    print(f"(v) launches on the analysis paths: {analysis}", flush=True)
    for k, v in analysis.items():
        launches[k] += v
    stored, w1 = drive_sharded_and_stored(dev, gpu)
    print(f"(w) launches on the sharded and stored-file paths: {stored}",
          flush=True)
    for k, v in stored.items():
        launches[k] += v
    torch.cuda.empty_cache()
    multi = drive_multihost(dev, gpu, q_refs, w1)
    print(f"(x) launches on the two-process paths: {multi}", flush=True)
    for k, v in multi.items():
        launches[k] += v
    torch.cuda.empty_cache()
    lofar, launches["xcorr"] = drive_lofar(dev, gpu)
    results.update(lofar)
    torch.cuda.empty_cache()
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on a path: {missing}")
    print(gpu)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **results[name])
        for name, (replaces, source) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
