"""Compiled execution of linear stream chains: one step per source block.

Counterpart of ``baseband_tasks_tpu/models/compiled.py``
(``CompiledPipeline``).  The lazy stream API (``base.py``) drives each
node's frame from the host; :class:`CompiledPipeline` walks a task chain
once and turns it into a single per-block step function, with the
overlap-save pads carried from block to block as state instead of
re-read.  The JAX package jits that step and scans it; here the step is a
plain Python function on tensors, and :meth:`CompiledPipeline.run_fn`
loops over blocks, as ``WidebandPulsarPipeline.run_fn`` does.

Supported chains: linear sequences of ``TaskBase`` subclasses whose
``task`` is a pure device function (Channelize, Dechannelize, Square,
Power, Task, Disperse/Dedisperse, the PFBs...), with ``SetAttribute``
relabels and ``GetSlice`` time slices (a slice is a pure shift of the
timeline, folded into the source's read offset, ``source_offsets``).  Not
ported yet (each raises NotImplementedError; ROADMAP.md queue 1):
``CombineStreamsBase`` joins (with ``combining.py``), the absorbed
``Integrate``/``Fold`` reduction (with ``integration.py``) and packed
ingest (``packed=True``, with I/O).

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
from math import gcd

import numpy as np
import torch

from ..base import BaseTaskBase, PaddedTaskBase, SetAttribute, TaskBase
from ..ops.dedisperse import _is_pow2, split_n
from ..ops.dft_matmul import DeviceMats, _expanded_mats
from ..ops.pfb import choose_block_rows, forward_geometry_ok
from ..shaping import GetSlice
from ..utils.dtypes import as_tensor, torch_dtype

__all__ = ["CompiledPipeline", "carry_from_numpy"]

_NOT_PORTED = "not ported yet (ROADMAP.md, queue 1 item {}: {})"


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
    """Compile a lazy task chain into one per-block step.

    Parameters
    ----------
    tail : stream
        The chain's last node; its input ancestry is walked up to the
        source stream.  The source itself is not compiled: blocks of
        source samples are the step input.
    block_samples : int, optional
        Source samples per block; padded stages pin it to their frame.
    fuse : bool
        Apply the kernel fusions (module docstring).
    packed : bool
        Packed-payload ingest: not ported yet (raises).
    """

    def __init__(self, tail, *, block_samples=None, fuse=True,
                 packed=False):
        if packed:
            raise NotImplementedError("packed ingest is " + _NOT_PORTED
                                      .format(9, "I/O, io/vdif.py"))
        self._run_cache = {}
        # the absorbed Integrate/Fold reduction waits for integration.py
        self.reduction = None
        self._tail = tail

        # -- walk the chain into a post-order program ---------------------
        # ("input", source_index) pushes a source block; ("entry", node)
        # transforms the top of the stack.
        program = []
        sources = []

        def build(node):
            if hasattr(node, "ihs"):
                raise NotImplementedError(
                    f"{type(node).__name__}: multi-input chains are "
                    + _NOT_PORTED.format(7, "combining.py"))
            if isinstance(node, BaseTaskBase):
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

        # -- block-size constraints, in units of the tail block B ---------
        # Every point p of the program carries block_p = coef_p * B (an
        # exact Fraction of the source block).  Non-padded rate-changing
        # stages add a granularity requirement; padded stages pin block_p
        # to their samples_per_frame.
        stages = []
        pinned = None
        constraints = []  # (coef, granularity): coef*B % gran == 0
        coef = Fraction(1)
        delay = Fraction(0)
        warmup = Fraction(0)
        source_offsets = [0] * len(sources)

        for kind, *rest in program:
            if kind == "input":
                continue
            n = rest[0]
            if isinstance(n, SetAttribute):
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, GetSlice):
                # a time slice is a pure shift: its start maps back to
                # start/coef source samples, folded into the read offset
                shift = Fraction(n._start) / coef
                if shift.denominator != 1:
                    raise ValueError(
                        f"GetSlice start {n._start} is not a whole "
                        f"number of source samples (stage rate ratio "
                        f"{coef}); slice at a multiple of "
                        f"{coef.numerator} samples instead")
                source_offsets[0] += int(shift)
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, PaddedTaskBase):
                need = Fraction(n.samples_per_frame) / coef
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
                delay += n.pad_start + n.pad_end
                warmup += n.pad_start + n.pad_end
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
                constraints.append((coef, _lcm(ratio.denominator, group)))
                coef *= ratio
                delay *= ratio
                warmup *= ratio
                continue
            raise ValueError(f"cannot compile node {type(n).__name__}")

        warmup = max(warmup, delay)
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
        #: per-source extra read offset (source samples) from GetSlice
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
        self.packed = False
        if fuse:
            self._apply_fusions()

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
        """The device of the source, where the step runs."""
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
        """Build every lazy device cache (chirps, gains, lane matrices,
        taps) before the first step, so no step copies from the host:
        each fusion's matrices, and each node's own lazy caches through
        its ``_prepare_device_caches``."""
        for st in self.stages:
            if st.fused is not None:
                st.fused.prepare()
            prepare = getattr(st.node, "_prepare_device_caches", None)
            if prepare is not None and not st.skip:
                prepare()

    def step_fn(self):
        """``(carry, block) -> (carry, out_block)``: one source block
        through the chain, complex data as complex tensors.  Each padded
        stage assembles its window as [carry | block] and keeps the
        window's last ``pad`` samples (a copy) as its next carry."""
        self._prepare_caches()
        stages = self.stages

        def step(carry, x):
            new_carry = []
            ci = 0
            for st in stages:
                if st.skip or isinstance(st.node, (SetAttribute, GetSlice)):
                    continue
                fn = st.fused if st.fused is not None else st.node
                if st.padded:
                    window = torch.cat([carry[ci], x], dim=0)
                    ci += 1
                    new_carry.append(window[window.shape[0] - st.pad:]
                                     .clone())
                    x = fn.task(window)
                else:
                    x = fn.task(x)
            return tuple(new_carry), x

        return step

    def planes_step(self):
        """``(carry, x, scale=None) -> (carry, (yr, yi))``: the step with
        values flowing as separate float32 re/im planes (``yi`` None for
        real data); ``x`` is a block tensor or an (re, im) pair.

        Stages with ``task_planes`` (the 'pallas' Disperse, the fusions,
        (De)Channelize by matrix products, the FIR) run on planes; any
        other stage goes through one complex recombination.  ``scale``
        (None, a number or a one-element tensor) multiplies the input of
        the first compute stage: inside its kernel, on the block rows
        only, when that stage is a streaming fusion.  Streaming stages
        get the carry as a separate buffer and assemble the window in
        their first kernel.
        """
        self._prepare_caches()
        stages = self.stages

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

        def step(carry, x, scale=None):
            x = to_pair(x)
            new_carry = []
            ci = 0
            pending = scale
            for st in stages:
                if st.skip or isinstance(st.node, (SetAttribute, GetSlice)):
                    continue
                fn = st.fused if st.fused is not None else st.node
                if st.padded:
                    c = carry[ci]
                    ci += 1
                    stream_fn = getattr(fn, "task_stream", None)
                    if (stream_fn is not None and x[1] is not None
                            and c[1] is not None
                            and 0 < st.pad <= x[0].shape[0]):
                        y = stream_fn(c, x, scale=pending)
                        if y is not NotImplemented:
                            # the kernel scales the block rows only, so
                            # the carried tail is scaled here to hold its
                            # own iteration's values
                            new_carry.append(tail_rows(x, st.pad, pending))
                            pending = None
                            x = y
                            continue
                    x = scaled(x, pending)
                    pending = None
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
                    x = scaled(x, pending)
                    pending = None
                y = NotImplemented
                planes_fn = getattr(fn, "task_planes", None)
                if planes_fn is not None:
                    y = planes_fn(x)
                if y is NotImplemented:
                    y = to_pair(fn.task(to_complex(x)))
                x = y
            return tuple(new_carry), x

        return step

    # -- running ----------------------------------------------------------
    def run_fn(self, n_blocks):
        """``run(blocks) -> out``: the step over ``n_blocks`` stacked
        source blocks (``(n_blocks, block_samples) + sample_shape``) from
        zeroed carries, a plain Python loop; ``out`` is the concatenated
        tail-rate output.  Cached per ``n_blocks``."""
        n_blocks = int(n_blocks)
        fn = self._run_cache.get(n_blocks)
        if fn is None:
            step = self.step_fn()

            def fn(blocks):
                carry = self.init_carry()
                outs = []
                for k in range(n_blocks):
                    carry, y = step(carry, blocks[k])
                    outs.append(y)
                return torch.cat(outs, dim=0)

            self._run_cache[n_blocks] = fn
        return fn

    def run_reduced(self, blocks):
        """The absorbed reduction's run: not ported yet."""
        raise NotImplementedError(
            "the absorbed Integrate/Fold reduction is "
            + _NOT_PORTED.format(7, "integration.py"))

    def run_blocks(self, blocks):
        """Run the compiled chain over stacked source blocks (a tensor or
        numpy array, taken to the source's device)."""
        blocks = as_tensor(blocks, device=self.device)
        return self.run_fn(blocks.shape[0])(blocks)

    def read_source_blocks(self, n_blocks, offset=0):
        """Read ``n_blocks`` blocks from the source, stacked for
        :meth:`run_blocks`."""
        B = self.block_samples
        src = self.source
        src.seek(self.source_offsets[0] + offset)
        return torch.stack([src.read(B) for _ in range(n_blocks)])
