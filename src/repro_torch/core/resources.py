"""Hardware resource models: the "compiler resource estimation" oracle.

The port's own copy of ``repro.core.resources``.  The FPGA models (the
paper's three boards, the row-band working set, the checkpoint planner
and the Table-1 latency model) are host arithmetic, copied verbatim so
that the port's design-space exploration gives the JAX package's
results exactly.  Every figure they return is an FPGA model output: a
modeled board utilization or a modeled FPGA latency, never a time on
the card.

The paper's DSE queries the Intel OpenCL compiler's first synthesis
stage for estimated %LUT/%DSP/%RAM/%register utilization.  Neither that
compiler nor FPGA hardware exist here, so this module provides an
**analytical estimator calibrated against the paper's own published
synthesis results** (Tables 1-3):

  anchors: 5CSEMA5 @ (8,8) -> ALM 26K, DSP 72, RAM 397/397, 2 Mbit
           Arria 10 @ (16,32) -> ALM 129K (30 %), DSP 300 (20 %), RAM 40 %
           5CSEMA4 @ (1,1) -> must NOT fit (control logic alone too big)
           VGG-16 uses ~8 % more Arria-10 RAM blocks than AlexNet

  fitted model (documented, not hard-coded decisions):
           ALM        = 11300 + 230 * (N_i*N_l)
           DSP        = 40    + ceil(N_i*N_l / 2)      # dual int8 MAC/DSP
           RAM blocks = 148 + 1.2 * (N_i*N_l) + 2.82 * weight_Mbytes
           regs       = 2.5 * ALM   (of 4 * ALM_avail)

The JAX package's TPU constants have their card counterpart here:
:class:`GPUProfile` / :data:`H100` (the data-sheet rates the kernel
bounds and the roofline divide by) and :data:`SMEM_BUDGET_BYTES`, the
shared memory one block may take, where the JAX package has
``VMEM_BUDGET_BYTES``.  :func:`report_from_trace` maps a traced step
(``launch/dryrun.py``) onto the four DSE quotas, the counterpart of the
JAX package's ``tpu_report_from_compiled``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# ------------------------------------------------------------------ FPGA

@dataclasses.dataclass(frozen=True)
class FPGAProfile:
    """Published capacities of the paper's three boards (Table 2)."""

    name: str
    alm: int
    dsp: int
    ram_blocks: int
    mem_bits: int
    f_max_mhz: float          # Table 1 achieved kernel clock
    ddr_gbps: float           # calibrated effective DDR bandwidth
    ram_bits_per_block: int = 10_000

    @property
    def reg(self) -> int:
        return 4 * self.alm


CYCLONE_V_5CSEMA4 = FPGAProfile(
    "Cyclone V SoC 5CSEMA4", alm=15_000, dsp=83, ram_blocks=321,
    mem_bits=2_000_000, f_max_mhz=131.0, ddr_gbps=0.78)
CYCLONE_V_5CSEMA5 = FPGAProfile(
    "Cyclone V SoC 5CSEMA5", alm=32_000, dsp=87, ram_blocks=397,
    mem_bits=4_000_000, f_max_mhz=131.0, ddr_gbps=0.78)
ARRIA_10_GX1150 = FPGAProfile(
    "Arria 10 GX 1150", alm=427_000, dsp=1516, ram_blocks=2713,
    mem_bits=55_500_000, f_max_mhz=199.0, ddr_gbps=4.95,
    ram_bits_per_block=20_000)

FPGA_BOARDS: Dict[str, FPGAProfile] = {
    "5CSEMA4": CYCLONE_V_5CSEMA4,
    "5CSEMA5": CYCLONE_V_5CSEMA5,
    "ARRIA10": ARRIA_10_GX1150,
}

# Framework option caps (§5 of the paper: "limited options to increase the
# level of parallelism" — the memory-read kernel's vector width is bounded
# by the 128-bit DDR burst (N_i <= 16) and the pipe width bounds N_l <= 32).
NI_CAP = 16
NL_CAP = 32


@dataclasses.dataclass
class ResourceReport:
    """What the 'compiler' hands back to the DSE agent (§4.4)."""

    percents: Dict[str, float]          # {lut, dsp, mem, reg} in [0, 100+]
    raw: Dict[str, float]
    fits: bool

    @property
    def f_avg(self) -> float:
        """Eq. (5): average usage factor."""
        p = self.percents
        return (p["lut"] + p["dsp"] + p["mem"] + p["reg"]) / 4.0


def estimate_fpga(profile: FPGAProfile, n_i: int, n_l: int,
                  weight_bytes: int) -> ResourceReport:
    """Calibrated analytical stand-in for the vendor compiler estimate."""
    alm = 11_300 + 230.0 * (n_i * n_l)
    dsp = 40 + math.ceil(n_i * n_l / 2)
    ram = 148 + 1.2 * (n_i * n_l) + 2.815 * (weight_bytes / 1e6)
    regs = 2.5 * alm
    mem_bits = ram * profile.ram_bits_per_block * 0.5
    percents = {
        "lut": 100.0 * alm / profile.alm,
        "dsp": 100.0 * dsp / profile.dsp,
        "mem": 100.0 * ram / profile.ram_blocks,
        "reg": 100.0 * regs / profile.reg,
    }
    raw = {"alm": alm, "dsp": dsp, "ram_blocks": ram, "regs": regs,
           "mem_bits": mem_bits}
    fits = all(v <= 100.0 for v in percents.values())
    return ResourceReport(percents=percents, raw=raw, fits=fits)


# --------------------------------------------- row-band working-set model

def conv_band_working_set(layers, n_l: int,
                          block_h: Optional[int],
                          n_i: Optional[int] = None,
                          per_channel: bool = False) -> int:
    """Peak per-grid-step VMEM bytes of the row-tiled kernels across the
    model's stage program (the quantity the DSE must keep under the
    on-chip budget — the paper's line-buffer/block-RAM sizing, §3.2.2).

    ``layers`` is the parsed ``LayerInfo`` schedule; ``n_l`` maps to the
    output-channel tile exactly as the executor maps it
    (``block_cout = 8 * N_l``) and ``n_i`` to the dense kernel's Cin
    contraction tile (``block_cin = 8 * N_i``; ``None`` scores the
    whole-Cin contraction); ``block_h=None`` scores the untiled
    whole-plane kernel.  Beyond dense convs the feasibility rule covers:

      * dense convs with a fused residual merge — the conv band plus
        the ``skip_vmem_bytes`` band the epilogue holds alongside it;
      * depthwise convs (any integer channel multiplier) — the
        channel-tiled band of ``dw_vmem_bytes`` (the input band shrinks
        with the channel tile, like the dense kernel's ``block_cin``
        slice, and with the multiplier), plus a fused residual band;
      * ragged grouped convs — the per-group band of
        ``gconv_vmem_bytes`` (the group axis is a grid axis, so the
        per-step set never scales with the group count);
      * residual merges — every operand band plus the int32 alignment
        intermediate and the output band (the skip buffer the paper
        would hold in block RAM while the main branch computes);
      * standalone concat merges — ONE output band plus the int32
        alignment intermediate and the int8 output: the operand slices
        partition the merge band, so charging every operand on top of
        the output would double-count the same bytes per branch;
      * fused concat merges (``concat_fused``) — zero: each producer
        conv writes its channel slice of the merge buffer from its own
        epilogue, so the charge already sits in the producers' bands.

    ``per_channel`` charges the per-lane requant-shift row (one int32
    per Cout lane of the tile, next to the bias row) every per-channel
    quantized grid step holds — the shift-vector bytes of DESIGN.md §8,
    so the DSE stays honest about the per-channel epilogue's working
    set.
    """
    from repro_torch.kernels import qconv  # kernels never import core: no cycle

    block_cout = max(8 * n_l, 8)
    block_cin = max(8 * n_i, 8) if n_i else None
    peak = 0
    for li in layers:
        if li.kind in ("add", "concat"):
            if li.concat_fused:
                continue  # producers write the merge buffer in place
            # concat operand slices partition the output band: charge
            # the merge once, not once per producer branch
            n_ops = 1 if li.kind == "concat" else len(li.inputs)
            if len(li.out_shape) == 4:  # spatial merge: row-banded
                _n, c, h, w = li.out_shape
                bh = min(block_h or h, h)
                band_elems = bh * w * c
            else:  # vector merge (MLP-style skip): whole tensor
                band_elems = int(math.prod(li.out_shape[1:]))
            # operand bands int8 + int32 add intermediate + out band
            peak = max(peak, band_elems * (n_ops + 4 + 1))
            continue
        if li.kind != "conv":
            continue
        _n, cin, h, w = li.in_shape
        pads = li.pads
        hp, wp = h + pads[0] + pads[2], w + pads[1] + pads[3]
        kh, kw = li.kernel_shape
        sh, sw = li.strides
        _n2, cout, oh, ow = li.out_shape
        pool = None
        if li.pool is not None:
            pool = (li.pool.kernel_shape[0], li.pool.strides[0])
        if li.is_dw_kernel:
            bc = min(block_cout, -(-cout // 128) * 128)
            ws = qconv.dw_vmem_bytes(wp, cout, kh, kw, bc, oh, ow,
                                     sh=sh, sw=sw, block_h=block_h,
                                     pool=pool, per_channel=per_channel,
                                     multiplier=cout // cin,
                                     skip=li.merge is not None)
        elif li.group > 1:  # ragged grouped conv: per-group band
            ws = qconv.gconv_vmem_bytes(
                wp, cin // li.group, cout // li.group, kh, kw, oh, ow,
                sh=sh, sw=sw, block_h=block_h, pool=pool,
                per_channel=per_channel)
        else:
            bco = min(block_cout, -(-cout // 128) * 128)
            ws = qconv.vmem_bytes(
                hp, wp, cin, kh, kw, bco, oh, ow,
                sh=sh, sw=sw, block_h=block_h, pool=pool,
                block_cin=block_cin, skip=li.merge is not None,
                per_channel=per_channel)
        peak = max(peak, ws)
    return peak


# ------------------------------------------ checkpoint placement model
#
# Stage-boundary recovery (DESIGN.md §11): the executor can snapshot the
# live int8 tensor environment at chosen stage boundaries so the guard
# replays only the stages downstream of a localized fault.  The snapshot
# is exactly the executor's liveness set — the functions below mirror
# the executor's ``last_use`` release rule byte for byte, so the DSE can
# charge checkpoint storage against the on-chip memory quota without
# building a program.


def _env_liveness(parsed):
    """(produced_at, last_use, int8_bytes) for every tensor that exists
    in the executor's environment, mirroring ``make_executor``:
    the graph input is produced "before stage 0" (index -1), the output
    is read by the egress (index ``len(layers)``), and fused-concat
    *producers* never put their output in the environment (they write a
    channel slice of the merge's shared buffer — only the Concat stage
    publishes the merged tensor)."""
    layers = parsed.layers
    last_use: Dict[str, int] = {}
    for idx, li in enumerate(layers):
        for t in li.inputs:
            last_use[t] = idx
    last_use[parsed.output_name] = len(layers)
    produced = {parsed.input_name: -1}
    nbytes = {parsed.input_name: int(math.prod(parsed.input_shape))}
    for idx, li in enumerate(layers):
        if li.concat is not None:
            continue  # writes the shared merge buffer, not the env
        produced[li.output] = idx
        nbytes[li.output] = int(math.prod(li.out_shape))
    return produced, last_use, nbytes


def checkpoint_live_bytes(parsed, boundary: int) -> Dict[str, int]:
    """``tensor -> int8 bytes`` of the snapshot taken after stage
    ``boundary`` completes: every tensor produced at or before the
    boundary whose last consumer lies strictly after it.  By the
    executor's own liveness rule this set is both sufficient and minimal
    for replaying stages ``boundary+1 ..``."""
    produced, last_use, nbytes = _env_liveness(parsed)
    return {t: nbytes[t] for t, p in produced.items()
            if p <= boundary < last_use.get(t, -1)}


def concat_group_spans(parsed) -> Tuple[Tuple[int, int, str], ...]:
    """``(start, end, merge_name)`` spans of stage indices where a
    fused-concat merge buffer is under construction: from each group's
    first producer up to (excluding) its Concat stage.  Boundaries in a
    span are invalid snapshot points — the half-built shared buffer is
    live but is not a named graph tensor.  Shared by
    :func:`eligible_checkpoints` and ``verify.check_checkpoint_boundaries``
    so the planner and the verifier can never disagree."""
    layers = parsed.layers
    name_idx = {li.name: i for i, li in enumerate(layers)}
    first: Dict[str, int] = {}
    for i, li in enumerate(layers):
        if li.concat is not None and li.concat.name in name_idx:
            first.setdefault(li.concat.name, i)
    return tuple(sorted((start, name_idx[name], name)
                        for name, start in first.items()))


def eligible_checkpoints(parsed) -> Tuple[int, ...]:
    """Stage indices that are valid snapshot boundaries: everything
    except the final stage (snapshotting after the output is produced
    recovers nothing) and boundaries inside a fused-concat group, where
    the half-built shared merge buffer is live but is not a named graph
    tensor (the executor rejects those too)."""
    blocked = set()
    for start, end, _name in concat_group_spans(parsed):
        blocked.update(range(start, end))
    return tuple(i for i in range(len(parsed.layers) - 1)
                 if i not in blocked)


def checkpoint_bytes(parsed, boundaries) -> int:
    """Total int8 bytes of all retained snapshots.  Snapshots are held
    for the whole inference (any of them may be the replay source), so
    the DSE charges their *sum*, not their max."""
    return sum(sum(checkpoint_live_bytes(parsed, b).values())
               for b in boundaries)


def plan_checkpoints(parsed, k: int) -> Tuple[int, ...]:
    """Place up to ``k`` checkpoints at equal cumulative-MAC split
    points over the eligible boundaries (DESIGN.md §11).

    The expected replay cost of a fault uniformly distributed over the
    schedule's MACs is minimized when the boundaries split the
    cumulative-MAC curve evenly — the j-th checkpoint targets
    ``total_macs * j / (k+1)``.  Ties (several boundaries equally close
    to a split point, common in merge-heavy graphs where merge stages
    cost 0 MACs) break toward the smaller snapshot, then the earlier
    boundary, so the plan is deterministic."""
    elig = list(eligible_checkpoints(parsed))
    if k <= 0 or not elig:
        return ()
    cum, acc = [], 0
    for li in parsed.layers:
        acc += li.macs
        cum.append(acc)
    total = max(acc, 1)
    sizes = {b: sum(checkpoint_live_bytes(parsed, b).values())
             for b in elig}
    k_eff = min(k, len(elig))
    chosen: set = set()
    for j in range(1, k_eff + 1):
        target = total * j / (k_eff + 1)
        best = min((b for b in elig if b not in chosen),
                   key=lambda b: (abs(cum[b] - target), sizes[b], b))
        chosen.add(best)
    return tuple(sorted(chosen))


# ------------------------------------------------------------------- GPU

@dataclasses.dataclass(frozen=True)
class GPUProfile:
    """Data-sheet constants of the card the port runs on: the rates the
    kernels' bounds divide by and the on-chip capacities a kernel's
    plan must fit.  The counterpart of the JAX package's ``TPUProfile``."""

    name: str = "NVIDIA H100 SXM5 80GB"
    sms: int = 132
    smem_per_block: int = 227 * 1024      # opt-in dynamic shared memory
    smem_per_sm: int = 228 * 1024
    registers_per_sm: int = 64 * 1024     # 32-bit registers
    hbm_bytes: int = 80 * 1024 ** 3
    hbm_bandwidth: float = 3.35e12        # bytes/s
    peak_int8_ops: float = 1979e12        # dense tensor-core peak
    peak_bf16_flops: float = 989e12       # dense tensor-core peak
    # NVLink 4 (data sheet): 18 links of 25 GB/s each way, 450 GB/s each
    # way (900 GB/s both ways) per card within an NVLink domain
    nvlink_links: int = 18
    nvlink_bandwidth: float = 450e9       # bytes/s each way, all links


H100 = GPUProfile()

#: Shared memory one thread block may take on the card: the counterpart
#: of the JAX package's ``VMEM_BUDGET_BYTES`` (a TPU core's VMEM budget)
#: for a kernel's on-chip working set.  The FPGA boards use their
#: published on-chip ``mem_bits`` instead.
SMEM_BUDGET_BYTES = H100.smem_per_block


def report_from_trace(meta: Dict, profile: GPUProfile = H100,
                      collective_bytes: Optional[float] = None
                      ) -> ResourceReport:
    """Map a traced step's record (``launch/dryrun.lower_cell``'s meta:
    ``flops_per_dev``, ``bytes_per_dev``, ``arg_bytes``, ``out_bytes``,
    ``temp_bytes``, ``collective_bytes_per_dev``) onto the four DSE
    quotas, with the formulas of the JAX package's
    ``tpu_report_from_compiled``:

    lut -> HBM residency %, dsp -> arithmetic-intensity balance (time on
    the tensor cores vs the step), mem -> temp (activation/workspace)
    pressure %, reg -> collective pressure relative to compute.
    Exceeding 100 on any quota means 'does not fit'."""
    flops = float(meta["flops_per_dev"])
    bytes_acc = float(meta["bytes_per_dev"])
    if collective_bytes is None:
        collective_bytes = float(meta["collective_bytes_per_dev"])
    resident = meta["arg_bytes"] + meta["out_bytes"] + meta["temp_bytes"]
    t_compute = flops / profile.peak_bf16_flops
    t_memory = bytes_acc / profile.hbm_bandwidth
    t_coll = collective_bytes / profile.nvlink_bandwidth
    denom = max(t_compute, 1e-12)
    percents = {
        "lut": 100.0 * resident / profile.hbm_bytes,
        "dsp": 100.0 * min(t_compute / max(t_compute, t_memory, t_coll), 1.0),
        "mem": 100.0 * meta["temp_bytes"] / profile.hbm_bytes,
        "reg": 100.0 * min(t_coll / denom, 2.0) / 2.0,
    }
    raw = {"flops": flops, "bytes": bytes_acc, "resident": resident,
           "t_compute": t_compute, "t_memory": t_memory,
           "t_collective": t_coll, "collective_bytes": collective_bytes}
    fits = percents["lut"] <= 100.0
    return ResourceReport(percents=percents, raw=raw, fits=fits)


# ------------------------------------------- per-stage modeled costs

def modeled_stage_costs(parsed, profile: "FPGAProfile", n_i: int,
                        n_l: int, block_h: Optional[int] = None,
                        per_channel: bool = False) -> Dict[str, Dict]:
    """Per-stage analytical costs in schedule order — the model side of
    the attribution join (``launch/profile.py``, DESIGN.md §12).

    For every scheduled stage: the Table-1 latency split
    (``model_s``/``t_compute_s``/``t_memory_s`` from
    :func:`fpga_layer_time_s`), the modeled DDR traffic
    (``ddr_bytes`` = input + weight + output bytes from
    ``pipeline.layer_bytes`` — fused merges report the bytes the fusion
    actually moves), the stage's row-band working set (``vmem_bytes``
    from :func:`conv_band_working_set` scored on that stage alone;
    zero for stages the band model does not charge) and its ``macs``.
    Keyed by stage name so measured wall times join by name.
    """
    from . import pipeline as pipe  # resources never imports at top: no cycle

    out: Dict[str, Dict] = {}
    for li in parsed.layers:
        in_b, w_b, out_b = pipe.layer_bytes(li)
        t, tc, tm = fpga_layer_time_s(profile, n_i, n_l, li.macs,
                                      in_b, w_b, out_b)
        out[li.name] = {
            "kind": li.kind,
            "model_s": t, "t_compute_s": tc, "t_memory_s": tm,
            "ddr_bytes": in_b + w_b + out_b,
            "vmem_bytes": conv_band_working_set(
                [li], n_l, block_h, n_i=n_i, per_channel=per_channel),
            "macs": li.macs,
        }
    return out


# ------------------------------------------------- FPGA latency model

def fpga_layer_time_s(profile: FPGAProfile, n_i: int, n_l: int,
                      macs: int, in_bytes: int, w_bytes: int,
                      out_bytes: int) -> Tuple[float, float, float]:
    """max(compute, memory) per pipelined stage (batch = 1).

    compute: one MAC per lane-vector element per cycle -> macs/(N_i*N_l*f).
    memory : weights + input + output once over effective DDR bandwidth
             (the deep pipeline means features stream, §3.2.3).
    Returns (time_s, t_compute, t_memory).

    Calibration residuals vs the paper's Table 1 (batch = 1) are
    reported by benchmarks/table1_latency.py: AlexNet/Arria and
    AlexNet/Cyclone within ~1 %, VGG/Arria -14 %, VGG/Cyclone -53 %.
    The VGG-on-Cyclone underestimate is expected: Table 1 shows that
    board's RAM at 100 % — feature maps spill and the resulting stall
    traffic is not captured by this first-order streaming model (the
    paper makes the same point about buffer limits in §5).
    """
    f = profile.f_max_mhz * 1e6
    t_c = macs / (n_i * n_l * f)
    t_m = (in_bytes + w_bytes + out_bytes) / (profile.ddr_gbps * 1e9)
    return max(t_c, t_m), t_c, t_m
