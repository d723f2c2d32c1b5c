"""The full-array sharded step: every antenna's DSP, the cross-antenna
coadd, and the production candidate plane, one program per rank over an
(ant, time) mesh.

Port of vlite_fast_tpu/parallel/sharded_pipeline.py on torch.distributed.
It replaces the reference's distributed topology (12 hosts of
independent process chains + per-beam heimdall searches + agdadacoadd MPI
reduce + agtriggerhook on the sum + a central coincidencer, SURVEY.md
section 1, scripts/start_heimdall_single_antenna:21,
scripts/start_process:21) with collectives:

  * DSP — antennas shard over all ranks (the mesh flattened): each
    antenna's seconds stream one after another through
    models/baseband_dsp.process_second, so the EMA bandpass carry is the
    sequential one by construction (ref pb_kernels.cu:406-411); which
    program serves each second is baseband_dsp.second_program's answer
    (on a card, the armed program on the arming second alone).  An
    observation's first call seeds each antenna's zero bandpass entries
    from its first second (models/baseband_dsp.seed_bandpass), as a
    station does.  The carried (bp, bp_kur) state enters and leaves the
    step, so consecutive calls continue one unbroken observation.
  * Reshard — one all_to_all_single over 'time' moves each antenna
    group's packed filterbank (2-bit bytes, not floats) from "whole
    stream on one rank" to "time chunk per rank": rank (a, t) then holds
    chunk t of every beam in ant-row a's group.
  * Per-beam search — each rank dedisperses and boxcar-filters its
    beams' chunk one beam at a time (the per-antenna heimdall role), with
    the previous chunk's tail from its 'time' neighbor (parallel/halo;
    chunk 0 uses the packed tail carried from the previous call, so the
    gulp overlap is seamless across calls, and on an observation's first
    call, which has no previous one, searches from the stream's first
    row).  Fixed-size packed top-k
    crossings per beam are the output (the models/search gulp pattern).
  * Coadd search — an all_reduce over 'ant' forms the incoherent sum (the
    agdadacoadd MPI reduce); the coadd chunk's search is split in time
    across the 'ant' rows.

extract_candidates() turns the packed crossings, gathered to the host by
gather_step_output(), into per-beam and coadd Candidate lists with the
single-beam clustering, feeding the coincidence plane (runtime/trigger).

The per-beam dedispersion takes ops/dedisperse_pallas's f32 entry (the
CUDA kernel on a card, the gather engine on the CPU) or, with
SearchConfig(engine='fourier'), ops/dedisperse.dedisperse_fourier, as
the JAX step's engines.  The coadd's all_reduce sums in the backend's
order, not the JAX psum's: its floats agree to rounding.

A call is a record of utils/spans (layer "call") when the caller passes
one to step_fn, gather_step_output and extract_candidates: host spans
"dispatch" (the step's host time), "gather", "decode" and "cluster", the
caller's root span "call" around them; counters "antenna_seconds",
"beams", "fused_seconds" (the antenna-seconds process_second handed to
a fused launch; absent where it handed none), "crossings" (beams and
coadd), "saturated_bands" and "cluster_rows"; device stages
process_second's own ("front", "wola", "dft", "detect", "ema", "pack",
summed over the call's antenna-seconds; a second handed to a fused
launch is "dft" alone), "reshard", each beam's "dedisperse" (its rows'
unpack with it), "boxcar" and "topk" (summed over the beams), "coadd"
(the sum, kept in the beam loop, the all_reduce and the scale) and
"coadd_search".  The record's
device span runs from the step's start to the end of the coadd search.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vlite_fast_tpu_torch.config import ArrayConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search as search_mod
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import normalize as norm_ops
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.parallel.halo import ppermute
from vlite_fast_tpu_torch.utils import spans


class ArrayStepOutput(NamedTuple):
    packed_kur: torch.Tensor   # (m, T, nbytes) this rank's beams' bytes
    beam_topk: torch.Tensor    # (1, beams_per_group, 2, nbands*kb+1) int32
                               # [d]: ant-row d//ntblk's beams, chunk
                               # d%ntblk; banded packed crossings
                               # (search.pack_topk_banded)
    coadd_topk: torch.Tensor   # (1, 2, nbands*kb_co+1) int32 coadd crossings
    weights_mean: torch.Tensor  # (m,) mean RFI weight over the call
    # gather_step_output stacks each field over the mesh (nant or ndev
    # leading rows), as the JAX step's global arrays


@dataclasses.dataclass(frozen=True)
class ArraySearchInfo:
    """Static geometry the host needs to decode ArrayStepOutput."""

    widths: tuple
    dms: tuple
    T: int            # output samples per call
    c: int            # samples per time chunk (T // ntblk)
    ca: int           # coadd sub-window per ant row (c // na, or c)
    coadd_split: bool  # True when the coadd search is subsplit over 'ant'
    halo: int         # overlap-save lookahead (plan.max_delay)
    na: int
    ntblk: int
    m: int            # antennas per rank
    mg: int           # beams per ant-row group (m * ntblk)
    nant: int
    k_beam: int
    k_co: int
    tsamp: float
    nbands: int = 1   # per-DM-band top-k quota (search.pack_topk_banded)


def _span(record, name: str):
    """The record's span `name`; nothing without a record."""
    return record.span(name) if record is not None \
        else contextlib.nullcontext()


def dequant_rows(packed: torch.Tensor, cfg) -> torch.Tensor:
    """(..., nbytes) packed rows -> (..., nchanout) f32 filterbank."""
    fb = q_ops.dequantize(packed, cfg.nbit)
    return fb.reshape(packed.shape[:-1] + (-1,))[..., :cfg.nchanout]


def search_topk(span: torch.Tensor, plan: dd.DedispPlan,
                info: "ArraySearchInfo", scfg: SearchConfig, ntime_out: int,
                k: int, skip: int = 0) -> torch.Tensor:
    """span: (ntime_out + halo, nchan) f32 -> (2, nbands*kb + 1) packed
    crossings, per-DM-band quota'd (search.boxcar_topk, the
    pack_topk_banded layout: the same RFI-storm guard the single-beam
    path uses).

    The first `skip` outputs lie before the stream's first sample: only
    span[skip:] is searched, so each DM's mean and noise come from the
    outputs from sample 0 on, and the skipped ones are S/N 0 (below any
    threshold; the time index stays the whole window's).

    Device stages of the bound record (spans.stage): "dedisperse",
    "boxcar", "topk"; the last runs on to the caller's next mark."""
    engine = search_mod.resolve_engine(scfg.engine, span.device)
    spans.stage("dedisperse")
    nt = max(0, ntime_out - skip)
    dmt = search_mod.dedisperse(span[skip:], plan, nt, engine=engine) \
        if nt else torch.zeros((len(plan.dms), 0), dtype=torch.float32,
                               device=span.device)
    return search_mod.boxcar_topk(dmt, plan.nchan_eff, info.widths, k,
                                  info.nbands, float(scfg.snr_thresh),
                                  skip=ntime_out - nt)


def build_array_step(acfg: ArrayConfig, mesh, nsec_per_call: int = 1,
                     k_beam: int = 0, k_co: int = 0, inject_sec: int = -1):
    """Returns (step_fn, make_inputs, plan, info) for this rank of `mesh`.

    inject_sec >= 0 arms the chain's FRB injection (requires
    pipeline.inject_frb=True) at the top of that second of every call, on
    every antenna: the in-graph signal test of the reference
    (src/process_baseband.cu:1098-1102 arms every 60 s); the search must
    then recover the burst at pipeline.inject_dm in every beam and in the
    coadd.

    step_fn(raw, bp, bp_kur, tail=None, record=None)
        -> (ArrayStepOutput, (bp2, bpk2, tail2)), this rank's shards:
      raw:  (m, npol, nsec_per_call*sample_rate) uint8
      bp(_kur): (m, npol, nchan) float32 EMA carry
      tail: (m, halo, nbytes) uint8 packed tail from the previous call,
      or None on an observation's first call: there is no history, and
      the search starts at the stream's first row, as heimdall's first
      gulp does (the outputs before sample 0 are S/N 0, and no DM's mean
      or noise reads them), and the zero entries of bp(_kur) are seeded
      from each antenna's first second (baseband_dsp.seed_bandpass)
      (rows [d*m, (d+1)*m) of the JAX step's P(('ant','time')) arrays,
      on the mesh's device).  Collective: every rank of the mesh calls
      it.  With `record` (a utils/spans Record of layer "call") the step
      binds it while it runs: its host time is the span "dispatch", its
      device stages are marked (the module docstring), and it counts
      "antenna_seconds" and "beams"; the outputs are the same bytes
      with a record and without.

    Geometry requirements (raised if violated):
      nant % ndev == 0; T % ntblk == 0; halo <= c (a chunk's lookahead
      comes from ONE neighbor: make calls at least ntblk * halo samples
      long, the same reason heimdall's 24 s gulps exceed the DM-1000
      sweep).
    """
    cfg = acfg.pipeline
    scfg = acfg.search
    nant = acfg.nant
    na, ntblk = mesh.shape["ant"], mesh.shape["time"]
    ndev = na * ntblk
    if mesh.d is None:
        raise ValueError("build_array_step: this rank is not in the mesh")
    if nant % ndev:
        raise ValueError(f"nant={nant} must divide over {ndev} devices")
    m = nant // ndev
    mg = m * ntblk                  # beams per ant-row group
    out_per_sec = cfg.seg_per_sec * cfg.out_samps_per_seg
    T = nsec_per_call * out_per_sec
    if T % ntblk:
        raise ValueError(f"T={T} output samples must divide into "
                         f"{ntblk} time chunks")
    c = T // ntblk

    dev = mesh.device
    freqs = cfg.freqs_mhz()
    dms = search_mod.make_dm_grid(scfg, cfg.tsamp, freqs)
    plan = dd.make_plan(dms, freqs, cfg.tsamp,
                        nsub=min(scfg.nsub, cfg.nchanout),
                        nbatch=min(scfg.nbatch, len(dms)),
                        zap_ranges=scfg.zap_ranges, device=dev)
    halo = int(plan.max_delay)
    if halo > c:
        raise ValueError(
            f"chunk ({c} samples) shorter than the max DM delay ({halo}); "
            f"raise nsec_per_call to >= {ntblk * halo / out_per_sec:.1f} s "
            "or lower dm_max")
    widths = search_mod.boxcar_widths(scfg.boxcar_max)
    coadd_split = (c % na == 0)
    ca = c // na if coadd_split else c

    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    use_kur = cfg.rfi_mode != 0
    cube_beam = len(widths) * len(dms) * c
    cube_co = len(widths) * len(dms) * ca
    k_beam = min(k_beam or max(512, 16 * scfg.max_candidates // ntblk),
                 cube_beam)
    k_co = min(k_co or max(512, 16 * scfg.max_candidates // (na * ntblk)),
               cube_co)
    # the JAX step's float32 of a float64 quotient (models/coadd's
    # coadd_psum takes a float32 root instead)
    inv_sqrt_nant = float(np.float32(1.0 / np.sqrt(nant)))
    nbands = search_mod.effective_nbands(len(dms), scfg.topk_dm_bands)
    rate = cfg.sample_rate

    info = ArraySearchInfo(
        widths=widths, dms=tuple(float(d) for d in dms), T=T, c=c, ca=ca,
        coadd_split=coadd_split, halo=halo, na=na, ntblk=ntblk, m=m, mg=mg,
        nant=nant, k_beam=k_beam, k_co=k_co, tsamp=cfg.tsamp,
        nbands=nbands)

    def step_fn(raw, bp, bp_kur, tail=None, record=None):
        if record is not None:
            record.counters.update(antenna_seconds=m * nsec_per_call,
                                   beams=mg)
        with _span(record, "dispatch"), spans.bound(record):
            spans.stage(None)
            return _step(raw, bp, bp_kur, tail)

    def _step(raw, bp, bp_kur, tail):
        # ---- DSP: each local antenna streams its seconds in turn --------
        packed = torch.empty((m, T, nbytes), dtype=torch.uint8, device=dev)
        wmean = torch.empty(m, dtype=torch.float32, device=dev)
        bp2, bpk2 = torch.empty_like(bp), torch.empty_like(bp_kur)
        rows = T // nsec_per_call
        for i in range(m):
            st = dsp.init_state(cfg, dev)._replace(bp=bp[i].contiguous(),
                                                   bp_kur=bp_kur[i]
                                                   .contiguous())
            wm = torch.empty(nsec_per_call, dtype=torch.float32, device=dev)
            for s in range(nsec_per_call):
                sec = raw[i, :, s * rate:(s + 1) * rate].contiguous()
                if s == 0 and tail is None:
                    # an observation's first call: its zero bandpass
                    # entries are seeded as a station's (a warm start's
                    # non-zero ones pass through), outside the stages
                    with spans.bound(None):
                        st = dsp.seed_bandpass(cfg, sec, st)
                o, st = dsp.process_second(cfg, sec, st, s == inject_sec)
                packed[i, s * rows:(s + 1) * rows] = \
                    o.packed_kur if use_kur else o.packed
                wm[s] = o.weights.sum() * norm_ops.recip(o.weights.numel())
            wmean[i] = wm.sum() * norm_ops.recip(nsec_per_call)
            bp2[i], bpk2[i] = st.bp, st.bp_kur
        # next call's search tail: the last `halo` packed rows of the
        # stream (halo <= c <= T)
        spans.stage("reshard")
        tail2 = packed[:, T - halo:].clone()

        # ---- reshard: (m, T, nb) -> group beams x my chunk -------------
        # the JAX all_to_all(split_axis=1, concat_axis=0) orders what it
        # receives by source, so the beam order within the group is
        # (source t', local antenna i), matching the all_gathered tails
        x = packed.reshape(m, ntblk, c, nbytes).transpose(0, 1).contiguous()
        chunk = torch.empty_like(x)
        dist.all_to_all_single(chunk, x, group=mesh.groups["time"])
        chunk = chunk.reshape(mg, c, nbytes)

        # ---- previous-chunk halo (overlap-save) -------------------------
        prev_in_call = ppermute(chunk[:, c - halo:], mesh, "time", 1)
        # chunk 0's history is the PREVIOUS call's tail (the input), not
        # the tail just computed from this call's end; on the first call
        # it has none: its rows are a stand-in that no search reads
        # (`first`, the outputs before sample 0, skipped below)
        first = tail is None and mesh.index("time") == 0
        if tail is not None:                # collective over 'time'
            tails = [torch.empty_like(tail) for _ in range(ntblk)]
            dist.all_gather(tails, tail.contiguous(),
                            group=mesh.groups["time"])
        if mesh.index("time"):
            prev = prev_in_call
        elif tail is not None:
            prev = torch.cat(tails)
        else:
            prev = torch.zeros_like(prev_in_call)
        span_packed = torch.cat([prev, chunk], dim=1)   # (mg, c+halo, nb)

        # ---- per-beam search (the heimdall-per-antenna role) ------------
        beam_topk, co = [], None
        for j in range(mg):
            spans.stage("dedisperse")
            fb = dequant_rows(span_packed[j], cfg)      # (c+halo, nchan)
            beam_topk.append(search_topk(fb, plan, info, scfg, c, k_beam,
                                         skip=halo if first else 0))
            spans.stage("coadd")
            co = fb if co is None else co.add_(fb)

        # ---- coadd + subsplit search (agdadacoadd + agtriggerhook) ------
        co = co.contiguous()
        dist.all_reduce(co, group=mesh.groups["ant"])
        co.mul_(inv_sqrt_nant)
        spans.stage("coadd_search")
        start = mesh.index("ant") * ca if coadd_split else 0
        with spans.bound(None):
            coadd_topk = search_topk(co[start:start + ca + halo], plan,
                                     info, scfg, ca, k_co,
                                     skip=max(0, halo - start) if first
                                     else 0)
        spans.stage(None)

        return (ArrayStepOutput(packed, torch.stack(beam_topk)[None],
                                coadd_topk[None], wmean),
                (bp2, bpk2, tail2))

    def make_inputs(seed: int = 0):
        """This rank's shards of the first call's inputs: raw from the
        JAX step's make_inputs(seed) draw (the same numpy sequence, so
        any mesh gives the inputs of a one-rank run), zero bandpasses,
        and no history (tail None: the JAX step draws `halo` rows of
        random levels there, which its search reads before sample 0)."""
        rng = np.random.default_rng(seed)
        nsamp = nsec_per_call * rate
        lo = mesh.d * m
        raw = np.empty((m, cfg.npol_in, nsamp), np.uint8)
        # antenna by antenna: the same stream as one (nant, ...) draw
        for a in range(nant):
            x = rng.standard_normal((cfg.npol_in, nsamp))
            if lo <= a < lo + m:
                raw[a - lo] = np.clip(x / 0.05914 + 128.5, 0,
                                      255).astype(np.uint8)
        bp = np.zeros((m, cfg.npol_in, cfg.nchan), np.float32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return put(raw), put(bp), put(bp.copy()), None

    return step_fn, make_inputs, plan, info


def gather_rows(t: torch.Tensor, mesh) -> np.ndarray:
    """Every mesh rank's `t`, concatenated along the leading axis in mesh
    order, as numpy on every rank of the mesh (an all_gather)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def gather_step_output(out: ArrayStepOutput, mesh,
                       record=None) -> ArrayStepOutput:
    """The whole mesh's ArrayStepOutput as numpy, on every rank of the
    mesh: packed_kur (nant, T, nbytes), beam_topk (ndev, mg, 2, ...),
    coadd_topk (ndev, 2, ...), weights_mean (nant,), the JAX step's
    global arrays.  Collective over the mesh.  It waits for the card:
    the span "gather" of `record`, if given."""
    with _span(record, "gather"):
        return ArrayStepOutput(*(gather_rows(t, mesh) for t in out))


def extract_candidates(out: ArrayStepOutput, info: ArraySearchInfo,
                       scfg: SearchConfig, call_base: int = 0,
                       record=None
                       ) -> Tuple[Dict[int, List[dd.Candidate]],
                                  List[dd.Candidate], Dict[str, int]]:
    """Decode one step's packed crossings (gather_step_output's) into the
    candidate plane.

    Returns ({beam: [Candidate]}, [coadd Candidate], stats) with peak/
    i0/i1 sample indices ABSOLUTE in the observation's output-sample
    stream (call_base = T * call_index).  The searched span of call k is
    [call_base - halo, call_base + T - halo) (from sample 0 on a first
    call, which has no history): the trailing halo samples
    wait for the next call's lookahead, exactly like heimdall's gulp
    overlap.  Crossings below scfg.snr_thresh or before sample 0 are
    dropped; clustering is the single-beam cluster_hits.  stats carries
    the crossing counts and the number of saturated top-k DM bands
    across all shards (search.decode_crossings semantics).  With
    `record`, the decoding and the clustering are its spans "decode" and
    "cluster", and stats and the rows handed to cluster_hits its
    counters "crossings", "saturated_bands" and "cluster_rows".
    """
    dms = np.asarray(info.dms)
    nw, ndm = len(info.widths), len(dms)
    stats = {"n_crossings": 0, "saturated_bands": 0}

    def decode(packed, ntime, base, into):
        """Crossings of one packed top-k at absolute sample `base`, those
        from sample 0 on appended to into's (hits, vals)."""
        vals, hits, n_cross, sat = search_mod.decode_crossings(
            packed, nw, ndm, ntime, info.nbands, scfg.snr_thresh)
        stats["n_crossings"] += n_cross
        stats["saturated_bands"] += sat
        if not len(vals):
            return
        hits = hits.copy()
        hits[:, 2] += base
        ok = hits[:, 2] >= 0
        if ok.any():
            into[0].append(hits[ok])
            into[1].append(vals[ok])

    rows = 0

    def cluster(into):
        nonlocal rows
        hits = np.concatenate(into[0])
        rows += len(hits)
        return dd.cluster_hits(hits, np.concatenate(into[1]), dms,
                               info.tsamp, widths=info.widths,
                               max_cands=scfg.max_candidates)

    btk = np.asarray(out.beam_topk)      # (ndev, mg, 2, nbands*kb+1)
    ctk = np.asarray(out.coadd_topk)     # (ndev, 2, nbands*kb_co+1)
    per_beam_hits: Dict[int, tuple] = {}
    co_hits = ([], [])
    with _span(record, "decode"):
        for d in range(btk.shape[0]):
            a, t = d // info.ntblk, d % info.ntblk
            base = call_base - info.halo + t * info.c
            for j in range(info.mg):
                decode(btk[d, j], info.c, base,
                       per_beam_hits.setdefault(a * info.mg + j, ([], [])))
        for d in range(ctk.shape[0]):
            a, t = d // info.ntblk, d % info.ntblk
            if not info.coadd_split and a != 0:
                continue        # unsplit: every ant row searched the same
            base = call_base - info.halo + t * info.c + (
                a * info.ca if info.coadd_split else 0)
            decode(ctk[d], info.ca, base, co_hits)
    with _span(record, "cluster"):
        per_beam = {beam: cluster(h) for beam, h in per_beam_hits.items()
                    if h[0]}
        coadd_cands = cluster(co_hits) if co_hits[0] else []
    if record is not None:
        record.counters.update(crossings=stats["n_crossings"],
                               saturated_bands=stats["saturated_bands"],
                               cluster_rows=rows)
    return per_beam, coadd_cands, stats
