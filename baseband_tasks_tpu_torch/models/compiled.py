"""Compiled execution of stream graphs: one step per source block.

Counterpart of ``baseband_tasks_tpu/models/compiled.py``
(``CompiledPipeline``).  The lazy stream API (``base.py``) drives each
node's frame from the host; :class:`CompiledPipeline` walks a task graph
once and turns it into a single per-block step function, with the
overlap-save pads carried from block to block as state instead of
re-read.  The JAX package jits that step and scans it; here the step is a
plain Python function on tensors, and :meth:`CompiledPipeline.run_fn`
loops over blocks, as ``WidebandPulsarPipeline.run_fn`` does.

Supported graphs:

- linear sequences of ``TaskBase`` subclasses whose ``task`` is a pure
  device function (Channelize, Dechannelize, Square, Power, Real2Complex,
  Task, Convolve, Disperse/Dedisperse, ShiftAndResample, ShiftSamples,
  the PFBs...), with ``SetAttribute`` relabels and ``GetSlice`` time
  slices (a slice is a pure shift of the timeline, folded into its
  sources' read offsets, ``source_offsets``);
- multi-input graphs: ``CombineStreamsBase`` nodes (CombineStreams,
  Concatenate, Stack) join several such chains, and the step takes one
  source block per input stream, in the order the walk meets them.
  Branches may arrive with different streaming delays and start offsets:
  both become per-source read offsets, where the shifts are whole source
  samples.

Packed-payload ingest (``packed=True``): sources that expose
``read_packed``/``packed_decode_fn`` (the file readers of ``io/``) give
their raw payloads as int32 words (with a presence mask for VDIF and
Mark 5B), and the step decodes them on the device before the first stage
(``ops/unpack.py``, plain torch ops, bit for bit against the readers'
host decode).  :meth:`CompiledPipeline.read_source_blocks` then stacks
``read_packed`` results instead of decoded samples; the planes step
refuses packed sources, as in the JAX package.

A trailing ``Integrate``, ``Fold`` or ``PulseStack`` is split off and
absorbed as a reduction: the step's output is summed into the node's bins
on the device (``index_add_`` by segment id), with the ids computed on the
host at two-double phase precision (:meth:`CompiledPipeline.segment_ids_np`)
and carried as one int64 tensor; :meth:`CompiledPipeline.run_reduced`
returns the averages and counts, :meth:`CompiledPipeline.run_fn` the sums
and counts.  Where the graph ends in the correlator's X stage on a card
(a ``CrossMultiply`` of all baselines i <= j, wide enough to fill the
card, into a plain, unmasked complex64 ``Integrate``;
:attr:`CompiledPipeline.x_form` 'fused'),
:meth:`CompiledPipeline.run_fn` runs each step up to the X stage's input
and adds the products into the sums in one kernel (``ops/xcorr.py``); the
counts keep their ``index_add_``.

Streaming semantics: each padded stage carries its last ``pad`` input
samples, so it needs one window of history before its output matches the
eager chain.  Compiled output sample k is eager sample k - ``delay``;
the first ``warmup`` samples are affected by the zero-initialized
carries.  Where every padded stage's ``samples_per_frame`` divides its
``pad`` the streaming windows coincide with eager frames and the outputs
agree to float roundoff; elsewhere they agree to the task's overlap-save
leakage.

Fusions (execution only; the bookkeeping above is that of the unfused
nodes), applied where the JAX package applies them, with the same gates:

- ``_FusedDisperseDechan``: Disperse(engine='pallas') → Dechannelize;
  the inverse DFT becomes the spectral filter's ``post`` lane mix;
- ``_FusedPFBForward``: the forward PFB's FIR → Channelize as one
  ``ops/pfb`` kernel pass with the DFT inside;
- ``_FusedDechanInvPFB``: Dechannelize → InversePolyphaseFilterBank
  (engine 'pallas'); the inverse DFT becomes the filter's ``pre`` mix and
  the carry moves to the spectra domain;
- the round-trip quad FIR → Channelize → Dechannelize → inverse PFB:
  the DFT and its inverse cancel, so the forward kernel emits the raw
  tap-sum and the filter runs without ``pre``.

The fused kernels run in :meth:`CompiledPipeline.planes_step`, where
complex data travels as float32 re/im planes, a per-iteration scale
rides into the first streaming kernel (block rows only) and streaming
stages assemble their windows from the carry inside the kernel.
"""

from __future__ import annotations

import inspect
from fractions import Fraction
from math import gcd, prod

import numpy as np
import torch

from ..base import BaseTaskBase, PaddedTaskBase, SetAttribute, TaskBase
from ..combining import CombineStreamsBase
from ..integration import Fold, Integrate, PulseStack, _phase_bins
from ..ops.dedisperse import _is_pow2, split_n
from ..ops.dft_matmul import DeviceMats, _expanded_mats
from ..ops.pfb import choose_block_rows, forward_geometry_ok
from ..ops.xcorr import MIN_BASELINE_CELLS, xcorr_accumulate
from ..shaping import GetSlice
from ..utils import units as u
from ..utils.dtypes import as_tensor, torch_dtype
from ..utils.profiling import span
from .beamform import BeamformStations
from .correlator import CrossMultiply

__all__ = ["CompiledPipeline", "carry_from_numpy", "init_reduction_acc",
           "make_reduction_update"]


class _CombineStage:
    """A join of ``k`` branches (a ``CombineStreamsBase`` node)."""

    __slots__ = ("node", "k")
    padded = False
    fused = None
    skip = False

    def __init__(self, node, k):
        self.node = node
        self.k = k


class _Stage:
    __slots__ = ("node", "padded", "pad", "in_block", "out_block",
                 "in_sample_shape", "in_dtype", "fused", "skip")

    def __init__(self, node, padded, pad, in_block, out_block):
        self.node = node
        self.padded = padded
        self.pad = pad
        self.in_block = in_block
        self.out_block = out_block
        self.in_sample_shape = tuple(node.ih.sample_shape)
        self.in_dtype = node.ih.dtype
        self.fused = None   # execution-override object (pair fusions)
        self.skip = False   # stage absorbed into a neighbour's fusion


def init_reduction_acc(red, sample_shape, n_seg, device):
    """Zeroed (sums, counts) accumulators of an absorbed reduction, with a
    trash segment ``n_seg`` at the end: sums in the node's accumulation
    dtype, int64 counts (per cell, with the sample shape, when masked)."""
    cells = tuple(sample_shape) if red._masked else ()
    return (torch.zeros((n_seg + 1,) + tuple(sample_shape),
                        dtype=red._acc_dtype(), device=device),
            torch.zeros((n_seg + 1,) + cells, dtype=torch.int64,
                        device=device))


def make_reduction_update(red):
    """``update(sums, counts, y, seg)``: add the tail block ``y`` into the
    accumulators by segment id ``seg`` (int64, one per sample), in place,
    with no host synchronisation (``index_add_``; ``bincount`` would read
    the largest id back to size its output).  With a masked reduction,
    non-finite cells drop out per cell."""
    acc_dtype = red._acc_dtype()

    def update(sums, counts, y, seg):
        if red._masked:
            valid = torch.isfinite(y)
            y = torch.where(valid, y, torch.zeros((), dtype=y.dtype,
                                                  device=y.device))
            counts.index_add_(0, seg, valid.to(torch.int64))
        else:
            counts.index_add_(0, seg, torch.ones_like(seg))
        sums.index_add_(0, seg, y.to(acc_dtype))
        return sums, counts

    return update


def _x_form(stage, red, device):
    """How :meth:`CompiledPipeline.run_fn` runs a graph's tail ``stage``
    into its reduction ``red``: 'fused' (the X stage and the sums' update
    as one ``xcorr`` launch a block, ``ops/xcorr.py``) for a
    ``CrossMultiply`` of every baseline i <= j of complex64 spectra, at
    least ``MIN_BASELINE_CELLS`` baselines x cells a spectrum, into a
    plain, unmasked complex64 ``Integrate`` (not a ``Fold`` or
    ``PulseStack``) on a CUDA device, else 'products' (the tail's task,
    then the update)."""
    node = stage.node
    if not (isinstance(node, CrossMultiply) and type(red) is Integrate
            and not red._masked and device.type == "cuda"
            and red._acc_dtype() == torch.complex64
            and np.dtype(stage.in_dtype) == np.complex64):
        return "products"
    n = node.ih.sample_shape[0]
    every = tuple((i, j) for i in range(n) for j in range(i, n))
    cells = prod(node.sample_shape) // (4 if node.full else 1)
    return ("fused" if node.baselines == every
            and cells >= MIN_BASELINE_CELLS else "products")


def _lcm(a, b):
    return int(np.lcm(int(a), int(b)))


def _pads_on_grid(node):
    """True when the node's pow2 window has pads on the four-step N2
    grid (the 'pallas' engine constructors arrange this)."""
    n = node._padded_samples_per_frame
    if not _is_pow2(n):
        return False
    n2 = split_n(n)[1]
    return node._pad_start % n2 == 0 and node._pad_end % n2 == 0


def _reps(sample_shape):
    return int(np.prod(sample_shape, dtype=int)) if sample_shape else 1


class _FusedDisperseDechan:
    """Execution fusion of ``Disperse(engine='pallas') → Dechannelize``:
    the dechannelize inverse DFT is a lane-axis mix, applied as the
    spectral filter's ``post`` (no extra pass over the window on the TPU;
    one lane_mix pass here), with the pads discarded in k3_trim."""

    def __init__(self, disp, dech):
        from ..ops.spectral_filter import lane_dft_mats
        self.disp = disp
        self.dech = dech
        self.post = lane_dft_mats(dech.n, inverse=True)
        self._post = DeviceMats(self.post)

    @staticmethod
    def can_fuse(disp, dech):
        from ..channelize import Dechannelize
        from ..dispersion import Disperse
        return (isinstance(disp, Disperse)
                and isinstance(dech, Dechannelize)
                and getattr(disp, "engine", None) == "pallas"
                and dech.ih is disp
                and len(disp.sample_shape) == 1
                and dech.n == disp.sample_shape[0]
                and np.dtype(dech.dtype).kind == "c"
                and not dech._fft.ortho
                and _pads_on_grid(disp))

    def prepare(self):
        self._post.on(self.disp.device)

    def task(self, window):
        x = window.to(torch.complex64)
        yr, yi = self.disp._task_pallas_planes(
            x.real.contiguous(), x.imag.contiguous(),
            post=self._post.on(x.device))
        return torch.complex(yr, yi).reshape(-1).to(
            torch_dtype(self.dech.dtype))

    def task_planes(self, pair):
        if pair[1] is None:
            return NotImplemented
        yr, yi = self.disp._task_pallas_planes(
            pair[0], pair[1], post=self._post.on(pair[0].device))
        return yr.reshape(-1), yi.reshape(-1)

    def task_stream(self, carry_pair, x_pair, scale=None):
        yr, yi = self.disp._task_pallas_stream(
            carry_pair, x_pair, scale=scale,
            post=self._post.on(x_pair[0].device))
        return yr.reshape(-1), yi.reshape(-1)


class _FusedPFBForward:
    """Execution fusion of ``_PolyphaseFIR → Channelize``: the forward
    polyphase filter bank as one ``ops/pfb`` kernel pass (the tap-sum
    over the carried window, then the F ⊗ I_reps DFT inside the kernel).

    ``with_dft=False`` (see :class:`_FusedPolyphaseFIR`) emits the raw
    tap-sum instead, for round-trip chains whose downstream inverse DFT
    cancelled the DFT.
    """

    def __init__(self, fir, chan, with_dft=True):
        self.fir = fir
        self.chan = chan
        self.with_dft = with_dft
        n = chan.n
        self.reps = _reps(fir.ih.sample_shape)
        self.n = n
        self.L = n * self.reps
        taps = fir._taps.cpu().numpy().reshape(fir._n_tap, n)
        self.taps_lanes = np.repeat(taps, self.reps, axis=1)
        self.mats = (_expanded_mats(n, self.reps, "forward")
                     if with_dft else (None, None))
        self._taps = DeviceMats((self.taps_lanes,))
        self._mats = DeviceMats(self.mats) if with_dft else None

    @staticmethod
    def can_fuse(fir, chan):
        from ..channelize import Channelize
        from ..pfb import _PolyphaseFIR
        if not (isinstance(fir, _PolyphaseFIR)
                and isinstance(chan, Channelize)
                and chan.ih is fir
                and np.dtype(fir.ih.dtype).kind == "c"
                and not chan._fft.ortho
                and chan.n == fir._n):
            return False
        m = fir.samples_per_frame // fir._n
        return forward_geometry_ok(m, fir._n * _reps(fir.ih.sample_shape),
                                   fir._n_tap)

    def prepare(self):
        self._taps.on(self.fir.device)
        if self._mats is not None:
            self._mats.on(self.fir.device)

    def _shape_out(self, y):
        return y.reshape((-1,) + tuple(self.chan.sample_shape))

    def task(self, window):
        y = self.fir.task(window)
        return self.chan.task(y) if self.with_dft else self._shape_out(y)

    def task_planes(self, pair):
        y = self.fir.task_planes(pair)
        if self.with_dft:
            return self.chan.task_planes(y)
        return (self._shape_out(y[0]),
                None if y[1] is None else self._shape_out(y[1]))

    def task_stream(self, carry_pair, x_pair, scale=None):
        from ..ops.pfb import pfb_forward_stream
        n, L = self.n, self.L
        m = x_pair[0].shape[0] // n
        if x_pair[0].shape[0] % n or not choose_block_rows(m, 8):
            return NotImplemented
        k = self.fir._n_tap - 1
        dev = x_pair[0].device
        fr, fi = self._mats.on(dev) if self._mats is not None \
            else (None, None)
        yr, yi = pfb_forward_stream(
            carry_pair[0].reshape(k, L), carry_pair[1].reshape(k, L),
            x_pair[0].reshape(m, L), x_pair[1].reshape(m, L),
            self._taps.on(dev)[0], fr, fi, n_tap=self.fir._n_tap,
            scale=scale)
        return self._shape_out(yr), self._shape_out(yi)


class _FusedPolyphaseFIR(_FusedPFBForward):
    """The forward-PFB half of the round-trip quad fusion
    ``_PolyphaseFIR → Channelize → Dechannelize →
    InversePolyphaseFilterBank``: the channelizing DFT and the
    dechannelize inverse DFT are exact adjoints and cancel, so this stage
    emits the raw tap-sum (the polyphase branches the Wiener
    deconvolution consumes) and the paired ``_FusedDechanInvPFB`` runs
    without its ``pre`` mix."""

    def __init__(self, fir, chan):
        super().__init__(fir, chan, with_dft=False)


class _FusedDechanInvPFB:
    """Execution fusion of ``Dechannelize → InversePolyphaseFilterBank``:
    the inverse DFT becomes the spectral filter's ``pre`` lane mix (a
    lane-axis mix commutes with the row-axis FFT), and the overlap-save
    carry moves to the (smaller) spectra domain."""

    def __init__(self, dech, inv, use_pre=True):
        from ..ops.spectral_filter import expand_lane_mats, lane_dft_mats
        self.dech = dech
        self.inv = inv
        self.reps = _reps(dech.ih.sample_shape[1:])
        if use_pre:
            mats = lane_dft_mats(inv._n, inverse=True)
            self.pre = expand_lane_mats(mats, self.reps) \
                if self.reps > 1 else mats
        else:
            # the round-trip quad: the upstream forward DFT cancelled
            # against this inverse DFT
            self.pre = None
        self._pre = DeviceMats(self.pre) if use_pre else None

    @staticmethod
    def can_fuse(dech, inv):
        from ..channelize import Dechannelize
        from ..pfb import InversePolyphaseFilterBank
        if not (isinstance(dech, Dechannelize)
                and isinstance(inv, InversePolyphaseFilterBank)
                and getattr(inv, "engine", None) == "pallas"
                and inv.ih is dech
                and dech.ih.sample_shape
                and dech.ih.sample_shape[0] == inv._n == dech.n
                and np.dtype(dech.dtype).kind == "c"
                and not dech._fft.ortho
                and inv._pad_start % inv._n == 0
                and inv._pad_end % inv._n == 0):
            return False
        rows = inv._padded_samples_per_frame // inv._n
        if not _is_pow2(rows):
            return False
        n2 = split_n(rows)[1]
        return (inv._pad_start // inv._n) % n2 == 0 \
            and (inv._pad_end // inv._n) % n2 == 0

    def prepare(self):
        if self._pre is not None:
            self._pre.on(self.inv.device)

    def _pre_on(self, device):
        return None if self._pre is None else self._pre.on(device)

    def task(self, window):
        m = window.shape[0]
        z = window.to(torch.complex64).reshape(m, -1)
        yr, yi = self.inv._task_pallas_planes(
            z.real.contiguous(), z.imag.contiguous(),
            pre=self._pre_on(z.device))
        out = torch.complex(yr, yi).reshape(
            (-1,) + tuple(self.inv.sample_shape))
        if self.inv.dtype.kind != "c":
            out = out.real
        return out.to(torch_dtype(self.inv.dtype))

    def _shape_out(self, yr, yi):
        yr = yr.reshape((-1,) + tuple(self.inv.sample_shape))
        if self.inv.dtype.kind != "c":
            return yr, None
        return yr, yi.reshape((-1,) + tuple(self.inv.sample_shape))

    def task_planes(self, pair):
        if pair[1] is None:
            return NotImplemented
        m = pair[0].shape[0]
        yr, yi = self.inv._task_pallas_planes(
            pair[0].reshape(m, -1), pair[1].reshape(m, -1),
            pre=self._pre_on(pair[0].device))
        return self._shape_out(yr, yi)

    def task_stream(self, carry_pair, x_pair, scale=None):
        m = x_pair[0].shape[0]
        mc = carry_pair[0].shape[0]
        yr, yi = self.inv._task_pallas_planes(
            x_pair[0].reshape(m, -1), x_pair[1].reshape(m, -1),
            pre=self._pre_on(x_pair[0].device), scale=scale,
            carry=(carry_pair[0].reshape(mc, -1),
                   carry_pair[1].reshape(mc, -1)))
        return self._shape_out(yr, yi)


def carry_from_numpy(carry, device=None):
    """The port's carry from a JAX ``CompiledPipeline``'s carry as numpy
    (``init_carry()`` entries for :meth:`CompiledPipeline.step_fn`,
    ``init_carry(planes=True)`` (re, im) pairs for
    :meth:`CompiledPipeline.planes_step`): the same nesting, each array a
    tensor on ``device``, ``None`` kept."""
    if carry is None:
        return None
    if isinstance(carry, (tuple, list)):
        return tuple(carry_from_numpy(c, device) for c in carry)
    return as_tensor(np.array(carry), device=device)


class CompiledPipeline:
    """Compile a lazy task graph into one per-block step.

    Parameters
    ----------
    tail : stream
        The graph's last node; its input ancestry is walked up to the
        source stream(s).  Sources are not compiled: blocks of source
        samples are the step input, one block per source
        (:attr:`sources`).
    block_samples : int, optional
        Source samples per block; padded stages pin it to their frame.
    fuse : bool
        Apply the kernel fusions (module docstring).
    packed : bool
        Packed-payload ingest: sources with ``read_packed`` take raw
        payload words as their block input and are decoded inside the
        step (module docstring); blocks and source offsets must then be
        whole multiples of such a source's ``packed_alignment``.

    A trailing ``Integrate``/``Fold``/``PulseStack`` is absorbed as a
    reduction (:attr:`reduction`; module docstring); :attr:`x_form` says
    whether :meth:`run_fn` fuses a correlator's X stage into it,
    :attr:`bf_form` how it forms a beamformer's TABs.
    """

    def __init__(self, tail, *, block_samples=None, fuse=True,
                 packed=False):
        self._run_cache = {}
        # split off a trailing reduction (Integrate and its subclasses)
        self.reduction = None
        if isinstance(tail, Integrate):
            self.reduction = tail
            tail = tail.ih
        self._tail = tail

        # -- walk the graph into a post-order program ---------------------
        # ("input", source_index) pushes a source block; ("entry", node)
        # transforms the top of the stack; ("combine", node, k) pops k
        # values and pushes the node's task of them.
        program = []
        sources = []

        def build(node):
            if isinstance(node, CombineStreamsBase):
                for ih in node.ihs:
                    build(ih)
                program.append(("combine", node, len(node.ihs)))
            elif isinstance(node, BaseTaskBase):
                build(node.ih)
                program.append(("entry", node))
            else:
                sources.append(node)
                program.append(("input", len(sources) - 1))

        build(tail)
        if len(program) == 1:
            raise ValueError("tail has no task nodes to compile")
        self.sources = sources
        self.source = sources[0]

        # -- block-size constraints, in units of the source block B -------
        # Every point p of the program carries block_p = coef_p * B (an
        # exact Fraction of the source block).  Non-padded rate-changing
        # stages add a granularity requirement; padded stages pin block_p
        # to their samples_per_frame.  Each branch on the stack carries its
        # coef, streaming delay, warmup and the sources feeding it.
        stages = []
        pinned = None
        constraints = []  # (coef, granularity): coef*B % gran == 0
        coef_stack, delay_stack, warmup_stack, srcs_stack = [], [], [], []
        source_offsets = [0] * len(sources)

        for kind, *rest in program:
            if kind == "input":
                coef_stack.append(Fraction(1))
                delay_stack.append(Fraction(0))
                warmup_stack.append(Fraction(0))
                srcs_stack.append([rest[0]])
                continue
            if kind == "combine":
                node, k = rest
                coefs, delays = coef_stack[-k:], delay_stack[-k:]
                warmups, branch_srcs = warmup_stack[-k:], srcs_stack[-k:]
                del coef_stack[-k:], delay_stack[-k:], warmup_stack[-k:]
                del srcs_stack[-k:]
                if len(set(coefs)) != 1:
                    raise ValueError(
                        "combined branches arrive with different block "
                        "sizes; give their stages matching frame sizes")
                # A branch at compiled index t holds its eager sample
                # t - d_b; the node joins eager samples t' + offset_b of
                # each branch.  Reading branch b's sources later by
                # (d_b + offset_b - D) / coef samples, with D the least
                # d_b + offset_b, aligns them all (no read before a
                # source's start).
                totals = [d + off for d, off in zip(delays, node._offsets)]
                d_common = min(totals)
                for lst, tot in zip(branch_srcs, totals):
                    shift = Fraction(tot - d_common) / coefs[0]
                    if shift.denominator != 1:
                        raise ValueError(
                            f"combined branches misaligned by "
                            f"{tot - d_common} samples = {float(shift)} "
                            f"source samples, not a whole number; adjust "
                            f"pads or slices so that branch shifts are "
                            f"whole source samples")
                    for i in lst:
                        source_offsets[i] += int(shift)
                coef_stack.append(coefs[0])
                delay_stack.append(d_common)
                # the slowest branch's carries set the warmup
                warmup_stack.append(max(warmups))
                srcs_stack.append([i for lst in branch_srcs for i in lst])
                stages.append(_CombineStage(node, k))
                continue
            n = rest[0]
            if isinstance(n, SetAttribute):
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, GetSlice):
                # a time slice is a pure shift: its start maps back to
                # start/coef source samples, folded into the read offsets
                shift = Fraction(n._start) / coef_stack[-1]
                if shift.denominator != 1:
                    raise ValueError(
                        f"GetSlice start {n._start} is not a whole "
                        f"number of source samples (stage rate ratio "
                        f"{coef_stack[-1]}); slice at a multiple of "
                        f"{coef_stack[-1].numerator} samples instead")
                for i in srcs_stack[-1]:
                    source_offsets[i] += int(shift)
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, PaddedTaskBase):
                need = Fraction(n.samples_per_frame) / coef_stack[-1]
                if need.denominator != 1:
                    raise ValueError("incompatible frame sizes along the "
                                     "chain")
                need = int(need)
                if pinned is None:
                    pinned = need
                elif pinned != need:
                    raise ValueError(
                        f"padded stages disagree on block size: "
                        f"{pinned} vs {need} source samples; "
                        f"construct them with matching samples_per_frame")
                stages.append(_Stage(n, True, n.pad_start + n.pad_end,
                                     n.samples_per_frame,
                                     n.samples_per_frame))
                delay_stack[-1] += n.pad_start + n.pad_end
                warmup_stack[-1] += n.pad_start + n.pad_end
                continue
            if isinstance(n, TaskBase):
                if "task" in n.__dict__ and inspect.ismethod(n.task):
                    raise ValueError(
                        "cannot compile a Task with a method-style "
                        "callable (it sees the stream position, which is "
                        "not defined in a compiled step); generate "
                        "position-dependent data in the source "
                        "(StreamGenerator) instead")
                ratio = Fraction(n.samples_per_frame,
                                 n._ih_samples_per_frame)
                stages.append(_Stage(n, False, 0, ratio.denominator,
                                     ratio.numerator))
                group = int(getattr(n, "_task_granularity", 1))
                constraints.append((coef_stack[-1],
                                    _lcm(ratio.denominator, group)))
                coef_stack[-1] *= ratio
                delay_stack[-1] *= ratio
                warmup_stack[-1] *= ratio
                continue
            raise ValueError(f"cannot compile node {type(n).__name__}")

        coef, delay = coef_stack[-1], delay_stack[-1]
        warmup = max(warmup_stack[-1], delay)
        # coef_p * B must be a multiple of gran for each constraint:
        # (n/d)*B ≡ 0 mod g  ⇔  B multiple of g·d / gcd(n, g·d)
        B = 1
        for c, gran in constraints:
            n_, d_ = c.numerator, c.denominator
            B = _lcm(B, gran * d_ // gcd(n_, gran * d_))
        if pinned is not None:
            if pinned % B:
                raise ValueError(
                    f"block of {pinned} source samples does not hold "
                    f"whole groups for all rate-changing stages (need a "
                    f"multiple of {B})")
            B = pinned
        if block_samples is not None:
            if block_samples % B or (pinned is not None
                                     and block_samples != pinned):
                raise ValueError(
                    f"block_samples={block_samples} incompatible: needs "
                    f"a multiple of {B}"
                    + (f" and padded stages pin {pinned}"
                       if pinned is not None else ""))
            B = int(block_samples)

        self.program = program
        self.stages = stages
        #: per-source extra read offset (source samples): GetSlice starts
        #: and the alignment of joined branches
        self.source_offsets = source_offsets
        self.block_samples = B
        self._tail_coef = coef
        t = coef * B
        if t.denominator != 1:
            raise ValueError("tail block is not integral; incompatible "
                             "frame sizes")
        self.tail_block = int(t)
        #: exact, in tail samples (fractional if a rate change follows a
        #: padded stage)
        self.delay = delay
        self.warmup = int(np.ceil(warmup))

        # -- packed-payload ingest ----------------------------------------
        self.packed = bool(packed)
        self._decoders = [None] * len(sources)
        if packed:
            for i, (src, extra) in enumerate(zip(sources, source_offsets)):
                make = getattr(src, "packed_decode_fn", None)
                if make is None:
                    continue  # this source stays on the float path
                align = src.packed_alignment
                if self.block_samples % align or extra % align:
                    raise ValueError(
                        f"packed ingest needs frame-aligned blocks: "
                        f"block_samples {self.block_samples} and source "
                        f"offset {extra} must be multiples of the file's "
                        f"{align} samples/frame")
                self._decoders[i] = make()
            if not any(d is not None for d in self._decoders):
                raise ValueError(
                    "packed=True but no source supports packed reads "
                    "(needs read_packed/packed_decode_fn)")
        if fuse:
            self._apply_fusions()

    @property
    def x_form(self):
        """'fused' where :meth:`run_fn` adds a ``CrossMultiply`` tail's
        products into the reduction's sums in one kernel a block, else
        'products' (:func:`_x_form`: decided by the graph and the
        device)."""
        return ("products" if self.reduction is None else
                _x_form(self.stages[-1], self.reduction, self.device))

    @property
    def bf_form(self):
        """How :meth:`run_fn` forms a tied-array beamformer tail's TABs
        (a ``BeamformStations`` with a TAB axis): 'products' (its task:
        one batched complex matrix product a block, the detection, then
        the reduction's update); None for any other graph."""
        node = self.stages[-1].node
        return ("products" if isinstance(node, BeamformStations)
                and node.n_tab is not None else None)

    def _apply_fusions(self):
        """Peephole pass: fuse adjacent stages whose second half is a
        pure lane-axis mix the kernels can absorb.  Execution only; the
        original nodes still work eagerly."""
        stages = self.stages
        # round-trip quad: the forward channelizing DFT and the inverse
        # dechannelize DFT are exact adjoints and cancel
        for i in range(len(stages) - 3):
            a, b, c, d = stages[i:i + 4]
            if any(st.skip or st.fused for st in (a, b, c, d)):
                continue
            if (_FusedPFBForward.can_fuse(a.node, b.node)
                    and _FusedDechanInvPFB.can_fuse(c.node, d.node)
                    and c.node.ih is b.node
                    and c.node.n == b.node.n):
                a.fused = _FusedPolyphaseFIR(a.node, b.node)
                b.skip = c.skip = True
                d.fused = _FusedDechanInvPFB(c.node, d.node, use_pre=False)
                n = d.node._n
                d.pad = (d.node.pad_start + d.node.pad_end) // n
                d.in_sample_shape = tuple(b.node.sample_shape)
                d.in_dtype = b.node.dtype
        for i in range(len(stages) - 1):
            a, b = stages[i], stages[i + 1]
            if a.skip or b.skip or a.fused or b.fused:
                continue
            if _FusedDisperseDechan.can_fuse(a.node, b.node):
                a.fused = _FusedDisperseDechan(a.node, b.node)
                b.skip = True
            elif _FusedPFBForward.can_fuse(a.node, b.node):
                a.fused = _FusedPFBForward(a.node, b.node)
                b.skip = True
            elif _FusedDechanInvPFB.can_fuse(a.node, b.node):
                b.fused = _FusedDechanInvPFB(a.node, b.node)
                a.skip = True
                # the carry moves to the spectra domain: pad rows of the
                # channelized input instead of pad samples
                n = b.node._n
                b.pad = (b.node.pad_start + b.node.pad_end) // n
                b.in_sample_shape = tuple(a.node.ih.sample_shape)
                b.in_dtype = a.node.ih.dtype

    # -- the step -------------------------------------------------------
    @property
    def device(self):
        """The device of the (first) source, where the step runs."""
        return getattr(self.source, "device", torch.device("cpu"))

    def init_carry(self, planes=False):
        """Zeroed overlap-save carries, one per padded stage: tensors of
        the stage's input dtype, or (re, im) float32 plane pairs (im None
        for real data) with ``planes``."""
        dev = self.device
        carries = []
        for st in self.stages:
            if not st.padded:
                continue
            shape = (st.pad,) + st.in_sample_shape
            if planes:
                complex_in = np.dtype(st.in_dtype).kind == "c"
                carries.append((
                    torch.zeros(shape, dtype=torch.float32, device=dev),
                    torch.zeros(shape, dtype=torch.float32, device=dev)
                    if complex_in else None))
            else:
                carries.append(torch.zeros(
                    shape, dtype=torch_dtype(st.in_dtype), device=dev))
        return tuple(carries)

    def _prepare_caches(self):
        """Build every lazy device cache (chirps, gains, responses, LO
        rotations, gather indices, lane matrices, taps) before the first
        step, so no step copies from the host: each fusion's matrices, and
        each node's own lazy caches through its
        ``_prepare_device_caches``."""
        for st in self.stages:
            if st.fused is not None:
                st.fused.prepare()
            prepare = getattr(st.node, "_prepare_device_caches", None)
            if prepare is not None and not st.skip:
                prepare()

    def _run_program(self, xs, value, combine, entry):
        """Walk the program over the step's source blocks ``xs`` (one
        tensor, or a tuple with one per source): ``value(x)`` makes a
        stack value of a source block, ``combine(stage, values)`` joins
        branches, ``entry(stage, x)`` runs a task stage (SetAttribute,
        GetSlice and the stages a fusion absorbed are passed over)."""
        inputs = xs if len(self.sources) > 1 else (xs,)
        stack = []
        stages = iter(self.stages)
        for kind, *rest in self.program:
            if kind == "input":
                stack.append(value(inputs[rest[0]]))
                continue
            st = next(stages)
            if isinstance(st, _CombineStage):
                args = stack[-st.k:]
                del stack[-st.k:]
                stack.append(combine(st, args))
            elif not (st.skip or isinstance(st.node, (SetAttribute,
                                                      GetSlice))):
                stack.append(entry(st, stack.pop()))
        return stack[-1]

    def _decode(self, xs):
        """Packed sources' blocks decoded on their device (``xs`` as
        :meth:`step_fn` takes it); other sources' blocks as they are."""
        if not self.packed:
            return xs
        if len(self.sources) > 1:
            return tuple(x if dec is None else dec(x)
                         for x, dec in zip(xs, self._decoders))
        dec = self._decoders[0]
        return xs if dec is None else dec(xs)

    def step_fn(self, pad_hook=None):
        """``(carry, blocks) -> (carry, out_block)``: one block per source
        through the graph (``blocks`` a tensor, or a tuple of them in
        :attr:`sources` order for a multi-input graph; a packed source's
        block is its ``read_packed`` words, or ``(words, mask)``, as
        tensors, decoded in the step), complex data as complex tensors.

        ``pad_hook(stage, carry_entry, x) -> (window, new_carry_entry)``
        sets how a padded stage assembles its overlap-save window from its
        carry and its input (the sharded executor, ``models/sharded.py``,
        passes one that exchanges the shards' tails); the default
        concatenates [carry | block] and keeps a copy of the window's last
        ``pad`` samples as the next carry."""
        return self._step(pad_hook or _concat_window)

    def _step(self, hook, tail=True):
        """:meth:`step_fn`'s step; with ``tail`` False it stops before the
        tail stage and returns that stage's input."""
        run = self._program_step(hook, _apply, tail)

        def step(carry, xs):
            return run(carry, self._decode(xs))

        return step

    def _program_step(self, hook, each, tail=True):
        """``run(carry, inputs) -> (carry, y)`` over decoded source blocks
        (``inputs`` as :meth:`_run_program` takes them).  ``each(fn,
        *values)`` applies a task to stack values: one tensor each for
        :meth:`step_fn`, per-shard lists for the sharded step, where each
        task then launches once per shard, stage by stage.  Padded stages
        take their windows from ``hook`` (see :meth:`step_fn`).  With
        ``tail`` False the tail stage passes its input through."""
        self._prepare_caches()
        last = None if tail else self.stages[-1]

        def run(carry, inputs):
            new_carry = []
            it = iter(carry)

            def entry(st, x):
                if st is last:
                    return x
                fn = st.fused if st.fused is not None else st.node
                if st.padded:
                    x, c = hook(st, next(it), x)
                    new_carry.append(c)
                return each(fn.task, x)

            def combine(st, args):
                return each(lambda *a: st.node.task(list(a)), *args)

            y = self._run_program(inputs, lambda x: x, combine, entry)
            return tuple(new_carry), y

        return run

    def planes_step(self):
        """``(carry, xs, scale=None) -> (carry, (yr, yi))``: the step with
        values flowing as separate float32 re/im planes (``yi`` None for
        real data); each source block is a tensor or an (re, im) pair
        (``xs`` a tuple of them for a multi-input graph).

        Stages with ``task_planes`` (the 'pallas' Disperse and Convolve,
        the fusions, (De)Channelize by matrix products, the FIR) run on
        planes; any other stage, and a join, goes through one complex
        recombination.  ``scale`` (None, a number or a one-element tensor)
        multiplies the input of the first compute stage: inside its
        kernel, on the block rows only, when that stage is a streaming
        one (``task_stream``: the 'pallas' Disperse, Convolve and
        ShiftAndResample, the fusions).  Streaming stages get the carry as
        a separate buffer and assemble the window in their first kernel.
        Packed sources are refused, as in the JAX package: their words go
        through :meth:`step_fn`.
        """
        if self.packed:
            raise NotImplementedError(
                "packed ingest is not wired into the planes-interchange "
                "step; use the normal step (the packed words decode "
                "inside step_fn)")
        self._prepare_caches()

        def to_pair(x):
            if isinstance(x, tuple):
                return tuple(None if p is None else
                             p.to(torch.float32).contiguous() for p in x)
            if x.is_complex():
                return (x.real.contiguous(), x.imag.contiguous())
            return x, None

        def to_complex(pair):
            re, im = pair
            return re if im is None else torch.complex(re, im)

        def scaled(pair, s):
            if s is None:
                return pair
            return (pair[0] * s, None if pair[1] is None else pair[1] * s)

        def tail_rows(pair, pad, s):
            # copies, so the carry never aliases a caller's block
            if s is None:
                return tuple(None if p is None else p[-pad:].clone()
                             for p in pair)
            return scaled((pair[0][-pad:], pair[1][-pad:]), s)

        def step(carry, xs, scale=None):
            new_carry = []
            it = iter(carry)
            pending = [scale]

            def take_scale():
                s, pending[0] = pending[0], None
                return s

            def combine(st, args):
                s = take_scale()
                args = [to_complex(a) for a in args]
                if s is not None:
                    args = [a * s for a in args]
                return to_pair(st.node.task(args))

            def entry(st, x):
                fn = st.fused if st.fused is not None else st.node
                if st.padded:
                    c = next(it)
                    stream_fn = getattr(fn, "task_stream", None)
                    if (stream_fn is not None and x[1] is not None
                            and c[1] is not None
                            and 0 < st.pad <= x[0].shape[0]):
                        y = stream_fn(c, x, scale=pending[0])
                        if y is not NotImplemented:
                            # the kernel scales the block rows only, so
                            # the carried tail is scaled here to hold its
                            # own iteration's values
                            new_carry.append(tail_rows(x, st.pad,
                                                       take_scale()))
                            return y
                    x = scaled(x, take_scale())
                    wr = torch.cat([c[0], x[0]], dim=0)
                    wi = None if x[1] is None else torch.cat(
                        [torch.zeros_like(c[0]) if c[1] is None else c[1],
                         x[1]], dim=0)
                    new_carry.append(tail_rows((wr, wi), st.pad, None)
                                     if st.pad else
                                     (wr[:0], None if wi is None
                                      else wi[:0]))
                    x = (wr, wi)
                else:
                    x = scaled(x, take_scale())
                y = NotImplemented
                planes_fn = getattr(fn, "task_planes", None)
                if planes_fn is not None:
                    y = planes_fn(x)
                if y is NotImplemented:
                    y = to_pair(fn.task(to_complex(x)))
                return y

            y = self._run_program(xs, to_pair, combine, entry)
            return tuple(new_carry), y

        return step

    # -- reduction (Integrate / Fold / PulseStack) --------------------------
    def _segment_ids(self, start, n):
        """Flat segment id of each eager-timeline tail sample in [start,
        start + n), on the host at two-double phase precision.  Samples
        outside every bin (negative warmup indices included) get id
        ``n_seg``, the trash segment.  Returns (int64 ids, n_seg)."""
        red = self.reduction
        rel0 = start - red._ih_start
        fine = red.n_phase if isinstance(red, PulseStack) else 1
        edges = red._get_offsets(np.arange(red.shape[0] * fine + 1))
        n_time = len(edges) - 1
        # the samples are consecutive and the edges whole sample offsets,
        # so the bins are runs between the edges: one pass over the ids
        # instead of a binary search per sample
        bounds = np.clip(edges, rel0, rel0 + n) - rel0
        ids = np.zeros(n, np.int64)
        valid = np.zeros(n, bool)
        ids[bounds[0]:bounds[-1]] = np.repeat(np.arange(n_time),
                                              np.diff(bounds))
        valid[bounds[0]:bounds[-1]] = True
        n_seg = n_time
        if isinstance(red, Fold):
            rel = np.arange(rel0, rel0 + n, dtype=np.int64)
            ih_rate = red.ih.sample_rate.to_value(u.Hz)
            t = (red.ih._tell_time(red._ih_start)
                 + u.Quantity(rel / ih_rate, u.s))
            ids = ids * red.n_phase + _phase_bins(red._phase, t, red.n_phase)
            n_seg = n_time * red.n_phase
        return np.where(valid, ids, n_seg), n_seg

    def segment_ids_np(self, n_blocks, tail_offset=0):
        """The reduction's segment ids of ``n_blocks`` compiled blocks, on
        the host: ``(ids, n_seg)`` with ``ids`` an (n_blocks, tail_block)
        int64 array (compiled sample k is eager sample k - delay; the
        carries' warmup samples go to the trash segment ``n_seg``).
        ``tail_offset`` shifts the eager timeline by whole tail samples,
        for a run resumed with fresh carries."""
        if self.delay != int(self.delay):
            raise ValueError(
                "cannot absorb a reduction after a fractional-delay "
                "chain; choose frame sizes with integral delay")
        ids, n_seg = self._segment_ids(tail_offset - int(self.delay),
                                       n_blocks * self.tail_block)
        # from tail_offset 0 the first ``delay`` samples already land at
        # negative eager indices; a resumed run's whole warmup is garbage
        w_extra = (self.warmup - int(self.delay) if tail_offset == 0
                   else self.warmup)
        if w_extra > 0:
            ids[:w_extra] = n_seg
        return ids.reshape(n_blocks, self.tail_block), n_seg

    def _shape_reduced(self, acc):
        """Sums or counts without the trash segment, in the eager node's
        bin layout ((bins, n_phase, ...) for Fold and PulseStack)."""
        acc = acc[:-1]
        if isinstance(self.reduction, (Fold, PulseStack)):
            return acc.reshape((-1, self.reduction.n_phase)
                               + tuple(acc.shape[1:]))
        return acc

    # -- running ----------------------------------------------------------
    def _block(self, blocks, k):
        """Block ``k`` of each source's stack (a packed source's stack is
        its words, or a (words, mask) pair): a tensor, or a tuple."""
        if len(self.sources) > 1:
            return tuple(_tree_map(lambda b: b[k], b) for b in blocks)
        return _tree_map(lambda b: b[k], blocks)

    def _prep_blocks(self, blocks):
        """Stacked source blocks (tensors or numpy arrays, as
        :meth:`read_source_blocks` gives them; a tuple with one per source
        for a multi-input graph) on the source's device, and their
        count."""
        def prep(b):
            return _tree_map(lambda a: as_tensor(a, device=self.device), b)
        blocks = (tuple(prep(b) for b in blocks) if len(self.sources) > 1
                  else prep(blocks))
        first = blocks
        while isinstance(first, tuple):
            first = first[0]
        return blocks, first.shape[0]

    def run_fn(self, n_blocks):
        """``run(blocks) -> out``: the step over ``n_blocks`` stacked
        source blocks (``(n_blocks, block_samples) + sample_shape``, a
        tuple of such stacks in :attr:`sources` order for a multi-input
        graph) from zeroed carries, a plain Python loop; ``out`` is the
        concatenated tail-rate output.  With an absorbed reduction
        ``run(blocks) -> (sums, counts)`` in the eager node's bin layout
        (its non-averaged read; :meth:`run_reduced` averages).  Cached per
        ``n_blocks``, with the segment ids on the device.  Its spans:
        ``compiled.call`` around the whole call, ``compiled.block`` around
        each block's step and its reduction update (a tail's task keeps
        its own span inside it: ``beamformer.bf`` around a beamformer's
        TAB products and detection).  With :attr:`x_form`
        'fused' the step stops at the X stage's input, and one ``xcorr``
        launch inside span ``correlator.x`` adds the block's products into
        the sums."""
        n_blocks = int(n_blocks)
        fn = self._run_cache.get(n_blocks)
        if fn is None:
            fn = self._run_cache[n_blocks] = self._run_fn(n_blocks,
                                                          self.x_form)
        return fn

    def _run_fn(self, n_blocks, x_form):
        """:meth:`run_fn`'s run, uncached, with the X stage in form
        ``x_form`` (:attr:`x_form`) whatever the graph and the device."""
        red = self.reduction
        fused = x_form == "fused"
        step = self._step(_concat_window, tail=not fused)
        if red is None:
            def fn(blocks):
                with span("compiled.call"):
                    carry = self.init_carry()
                    outs = []
                    for k in range(n_blocks):
                        with span("compiled.block"):
                            carry, y = step(carry, self._block(blocks, k))
                        outs.append(y)
                    return torch.cat(outs, dim=0)
        else:
            ids, n_seg = self.segment_ids_np(n_blocks)
            ids = torch.as_tensor(ids, device=self.device)
            if fused:
                full = self.stages[-1].node.full
                ones = torch.ones_like(ids[0])

                def update(sums, counts, x, seg):
                    with span("correlator.x"):
                        xcorr_accumulate(x, seg, sums, full=full)
                    counts.index_add_(0, seg, ones)
            else:
                update = make_reduction_update(red)

            def fn(blocks):
                with span("compiled.call"):
                    carry = self.init_carry()
                    sums, counts = init_reduction_acc(
                        red, self._tail.sample_shape, n_seg, self.device)
                    for k in range(n_blocks):
                        with span("compiled.block"):
                            carry, y = step(carry, self._block(blocks, k))
                            update(sums, counts, y, ids[k])
                    return (self._shape_reduced(sums),
                            self._shape_reduced(counts))

        return fn

    def run_reduced(self, blocks):
        """The absorbed reduction over stacked source blocks (as
        :meth:`run_blocks` takes them): ``(averages, counts)``, the
        averages in the node's accumulation dtype.  A masked reduction's
        fully flagged cells average to NaN, as the eager node's do."""
        if self.reduction is None:
            raise ValueError("no reduction to run")
        blocks, n_blocks = self._prep_blocks(blocks)
        return self._averaged(*self.run_fn(n_blocks)(blocks))

    def _averaged(self, sums, counts):
        """(averages, counts) of a reduction's sums and counts."""
        shaped = counts.reshape(tuple(counts.shape)
                                + (1,) * (sums.ndim - counts.ndim))
        out = sums / shaped.clamp_min(1)
        if self.reduction._masked:
            out = torch.where(shaped > 0, out, torch.full(
                (), float("nan"), dtype=out.dtype, device=out.device))
        return out, counts

    def run_blocks(self, blocks):
        """Run the compiled graph over stacked source blocks (tensors or
        numpy arrays, taken to the source's device; a tuple of them, one
        per source, for a multi-input graph; packed sources take their
        ``(words, mask)`` stacks from :meth:`read_source_blocks`)."""
        blocks, n_blocks = self._prep_blocks(blocks)
        return self.run_fn(n_blocks)(blocks)

    def read_source_blocks(self, n_blocks, offset=0):
        """Read ``n_blocks`` blocks from each source at its read offset,
        stacked for :meth:`run_blocks` (a tuple for a multi-input
        graph), on the source's device.  Packed sources (``packed=True``)
        come back as stacks of their raw ``read_packed`` words (and
        masks): no host decode happens here."""
        B = self.block_samples
        stacks = []
        for i, (src, extra) in enumerate(zip(self.sources,
                                             self.source_offsets)):
            if self._decoders[i] is not None:
                packs = [src.read_packed(extra + offset + k * B, B)
                         for k in range(n_blocks)]
                stacks.append(_tree_map(
                    lambda *xs: as_tensor(np.stack(xs), device=self.device),
                    *packs))
                continue
            src.seek(extra + offset)
            stacks.append(torch.stack([src.read(B) for _ in range(n_blocks)]))
        return tuple(stacks) if len(stacks) > 1 else stacks[0]


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally nested tuples (a packed block is
    its words or a (words, mask) pair); a leaf is anything else."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _apply(fn, *values):
    return fn(*values)


def _concat_window(st, carry, x):
    """The one-device pad hook: the window [carry | x] and a copy of its
    last ``pad`` samples, the stage's next carry (never a view of a
    block)."""
    window = torch.cat([carry, x], dim=0)
    return window, window[window.shape[0] - st.pad:].clone()
