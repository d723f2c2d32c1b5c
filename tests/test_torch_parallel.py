"""The port's parallel/ package (vlite_fast_tpu_torch.parallel) against the
JAX package's, with the port's ranks on gloo.

One spawn of four CPU ranks (a FileStore rendezvous, a timeout) runs every
port case: the mesh shapes and errors, the halo exchanges at (1,4), the
coadd's all_reduce at (2,2), the sharded coherent dedispersion at (1,4),
the array step on meshes 1x1, 1x2, 2x1 and 2x2 (and a second 2x2 call
continuing the JAX step's state), the 2-bit first call on 1x1 (from
make_inputs, which gives the port's step no history and the JAX step
random bytes, and from a warm-up), and the dry run at world 1 and 4.
The port's step seeds an observation's zero bandpasses from each
antenna's first second (baseband_dsp.seed_bandpass); the JAX step's
first calls compared with it take the port's seed (tests/jax_seeded.py).
The JAX side runs here, on the conftest's 8-device CPU mesh.  The ranks import
this module to find their job, so jax is imported inside the tests only.

The array step runs at tests/multihost_worker.py:arraystep_config's
geometry with the chain's FRB armed at the top of each call (DM 50): the
noise alone gives no candidate at that size.  The JAX step takes
ema_impl='scan', its sequential EMA, which the port's is: its 'assoc'
form departs from it where the kurtosis stream's bandpass clips under the
burst (test_jax_assoc_ema_departs_under_clipped_burst).
"""

import dataclasses

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT = 240.0
MESHES = ((1, 1), (1, 2), (2, 1), (2, 2))
NSEC = 2
SEED, SEED2 = 7, 8
COH = dict(dm=150.0, rate=1_000_000, nsamp=1 << 18, bw=0.5, fbot=320.0)


def _acfg():
    from multihost_worker import arraystep_config
    acfg = arraystep_config()
    return dataclasses.replace(acfg, pipeline=dataclasses.replace(
        acfg.pipeline, inject_frb=True, inject_dm=50.0, inject_amp=3.0,
        ema_impl="scan"))


def _port_acfg(acfg):
    """The JAX ArrayConfig as the port's (the same fields)."""
    from vlite_fast_tpu_torch import config as tc
    return tc.ArrayConfig.from_json(acfg.to_json())


def _acfg_2bit():
    """#6's geometry: _acfg() at 1 MS/s and 2 bits, where the JAX step's
    first call, from make_inputs' random-byte history, saturates DM
    bands."""
    acfg = _acfg()
    return dataclasses.replace(acfg, pipeline=dataclasses.replace(
        acfg.pipeline, sample_rate=1_000_000, nbit=2))


def _warm_state(acfg, halo):
    """benchmarks/fullgeom_mesh.initial_state for every antenna of a
    one-rank mesh: the first call continuing an observation."""
    import types

    from vlite_fast_tpu_torch.benchmarks import fullgeom_mesh as fg
    mesh = types.SimpleNamespace(d=0, device=torch.device("cpu"))
    info = types.SimpleNamespace(m=acfg.nant, halo=halo)
    return tuple(a.numpy() for a in fg.initial_state(
        mesh, _port_acfg(acfg).pipeline, info, seed=0))


def _port_seed(acfg, raw):
    """(bp, bp_kur) numpy (nant, npol, nchan): the port's seed_bandpass of
    each antenna's first second of raw (nant, npol, nsamp)."""
    from jax_seeded import port_seed
    cfg = acfg.pipeline
    seeds = [port_seed(cfg, raw[a, :, :cfg.sample_rate])
             for a in range(acfg.nant)]
    return tuple(np.stack([s[i] for s in seeds]) for i in (0, 1))


def _raw2(nant, npol, nsamp):
    rng = np.random.default_rng(SEED2)
    return np.clip(rng.standard_normal((nant, npol, nsamp)) / 0.05914
                   + 128.5, 0, 255).astype(np.uint8)


def _rank_job(acfg_json, dispersed, jax_state, raw2, acfg2_json, warm):
    """Every port case, on each of the WORLD gloo ranks."""
    import torch.distributed as dist

    from vlite_fast_tpu_torch.config import ArrayConfig
    from vlite_fast_tpu_torch.interop import array_state_from_jax
    from vlite_fast_tpu_torch.models.coadd import coadd_psum
    from vlite_fast_tpu_torch.parallel.distributed import local_shard
    from vlite_fast_tpu_torch.parallel.dryrun import dryrun_multichip
    from vlite_fast_tpu_torch.parallel.halo import (halo_from_next,
                                                    halo_from_prev)
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh
    from vlite_fast_tpu_torch.parallel.sharded_coherent import (
        coherent_dedisperse_sharded)
    from vlite_fast_tpu_torch.parallel.sharded_pipeline import (
        build_array_step, gather_rows, gather_step_output)

    rank = dist.get_rank()
    res = {"shapes": [dict(make_mesh(**kw).shape) for kw in
                      ({}, {"n_ant": 2, "n_time": 2}, {"n_ant": 3},
                       {"n_time": 2})]}
    try:
        make_mesh(n_ant=3, n_time=2)
    except ValueError as e:
        res["error"] = str(e)

    m14 = make_mesh(n_ant=1, n_time=4)
    x = torch.arange(16 * 2, dtype=torch.float32).reshape(16, 2)
    x_l = x[4 * rank:4 * rank + 4]
    res["halo_next"] = halo_from_next(x_l, 2, m14).numpy()
    res["halo_prev"] = halo_from_prev(x_l, 1, m14).numpy()

    m22 = make_mesh(n_ant=2, n_time=2)
    fb = np.random.default_rng(1).standard_normal((8, 16, 8)).astype(
        np.float32)
    a = m22.index("ant")
    res["coadd_psum"] = coadd_psum(torch.from_numpy(fb[4 * a:4 * a + 4]),
                                   m22, "ant", 8).numpy()

    span = COH["nsamp"] // WORLD
    res["coherent"] = coherent_dedisperse_sharded(
        torch.from_numpy(np.ascontiguousarray(
            dispersed[:, rank * span:(rank + 1) * span])),
        m14, COH["dm"], COH["rate"], COH["bw"], COH["fbot"]).numpy()

    acfg = ArrayConfig.from_json(acfg_json)
    res["step"] = {}
    for na, nt in MESHES:
        mesh = make_mesh(n_ant=na, n_time=nt)
        if mesh.d is None:
            continue
        step_fn, make_inputs, plan, info = build_array_step(
            acfg, mesh, nsec_per_call=NSEC, inject_sec=0)
        out, state = step_fn(*make_inputs(seed=SEED))
        calls = [(gather_step_output(out, mesh),
                  [gather_rows(t, mesh) for t in state])]
        if (na, nt) == (2, 2):
            out2, state2 = step_fn(local_shard(raw2, mesh),
                                   *array_state_from_jax(*jax_state, mesh))
            calls.append((gather_step_output(out2, mesh),
                          [gather_rows(t, mesh) for t in state2]))
        if rank == 0:
            res["step"][(na, nt)] = (calls, info, plan)
    # #6 at 2 bits: the first call from make_inputs (no history), then
    # from a warm-up, on a 1x1 mesh
    mesh = make_mesh(n_ant=1, n_time=1)
    if mesh.d is not None:
        acfg2 = ArrayConfig.from_json(acfg2_json)
        step_fn, make_inputs, _, info = build_array_step(
            acfg2, mesh, nsec_per_call=NSEC, inject_sec=0)
        raw, *history = make_inputs(seed=SEED)
        res["2bit"] = ({start: gather_step_output(step_fn(raw, *state)[0],
                                                  mesh)
                        for start, state in (
                            ("history", history),
                            ("warm", [torch.from_numpy(a) for a in warm]))},
                       info)
    res["dryrun"] = {n: dryrun_multichip(n) for n in (WORLD, 1)}
    return res


@pytest.fixture(scope="module")
def run():
    """The JAX side here, then the port's ranks."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlite_fast_tpu.ops import coherent as jcoh
    from vlite_fast_tpu.parallel.mesh import make_mesh
    from vlite_fast_tpu.parallel.sharded_pipeline import build_array_step
    from vlite_fast_tpu_torch.parallel.distributed import spawn

    def smap(f, mesh, spec, x):
        return np.asarray(shard_map(f, mesh=mesh, in_specs=spec,
                                    out_specs=spec, check_vma=False)(
            jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))))

    from vlite_fast_tpu.models.coadd import coadd_psum
    from vlite_fast_tpu.parallel.halo import halo_from_next, halo_from_prev
    from vlite_fast_tpu.parallel.sharded_coherent import (
        coherent_dedisperse_sharded)

    jx = {}
    m14 = make_mesh(n_ant=1, n_time=4)
    x = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    jx["halo_next"] = smap(lambda v: halo_from_next(v, 2, "time"), m14,
                           P("time"), x).reshape(4, 6, 2)
    jx["halo_prev"] = smap(lambda v: halo_from_prev(v, 1, "time"), m14,
                           P("time"), x).reshape(4, 5, 2)
    m22 = make_mesh(n_ant=2, n_time=2)
    fb = np.random.default_rng(1).standard_normal((8, 16, 8)).astype(
        np.float32)
    jx["coadd_psum"] = smap(lambda v: coadd_psum(v, "ant", 8)[None], m22,
                            P("ant"), fb)
    x = np.random.default_rng(0).standard_normal(
        (2, COH["nsamp"])).astype(np.float32)
    ker = jcoh.dispersion_kernel(COH["nsamp"], COH["dm"],
                                 bandwidth_mhz=COH["bw"],
                                 freq_bot_mhz=COH["fbot"], taper=False)
    dispersed = np.asarray(jcoh.apply_chirp(jnp.asarray(x), ker))
    sh = NamedSharding(m14, P(None, "time"))
    jx["coherent"] = np.asarray(coherent_dedisperse_sharded(
        jax.device_put(jnp.asarray(dispersed), sh), m14, COH["dm"],
        COH["rate"], bandwidth_mhz=COH["bw"], freq_bot_mhz=COH["fbot"]))

    acfg = _acfg()
    step_fn, make_inputs, _, jinfo = build_array_step(
        acfg, m22, nsec_per_call=NSEC, inject_sec=0)
    raw, _, _, history = make_inputs(seed=SEED)
    sh = NamedSharding(m22, P(("ant", "time")))
    seeded = [jax.device_put(a, sh) for a in _port_seed(acfg,
                                                         np.asarray(raw))]
    out, state = step_fn(raw, *seeded, history)
    jax_state = tuple(np.asarray(a) for a in state)
    cfg = acfg.pipeline
    raw2 = _raw2(acfg.nant, cfg.npol_in, NSEC * cfg.sample_rate)
    out2, state2 = step_fn(jax.device_put(raw2, sh), *state)
    jx["calls"] = [(jax.tree.map(np.asarray, o), [np.asarray(a) for a in s])
                   for o, s in ((out, state), (out2, state2))]
    jx["info"] = jinfo

    acfg2 = _acfg_2bit()
    step_fn, make_inputs, _, info2 = build_array_step(
        acfg2, make_mesh(n_ant=1, n_time=1, devices=jax.devices()[:1]),
        nsec_per_call=NSEC, inject_sec=0)
    raw, *history = make_inputs(seed=SEED)
    warm = _warm_state(acfg2, info2.halo)
    # "zero": the warm-up's history, but the zero bandpasses of a fresh
    # state, which the JAX step seeds from its first tile
    zero = [history[0], history[1], jnp.asarray(warm[2])]
    jx["2bit"] = ({start: jax.tree.map(np.asarray, step_fn(raw, *state)[0])
                   for start, state in (("history", history),
                                        ("warm", [jnp.asarray(a) for a in warm]),
                                        ("zero", zero))},
                  info2)

    ranks = spawn(_rank_job, WORLD, _port_acfg(acfg).to_json(), dispersed,
                  jax_state, raw2, _port_acfg(acfg2).to_json(), warm,
                  timeout=TIMEOUT)
    return {"jax": jx, "ranks": ranks, "acfg": acfg, "x": x}


def test_make_mesh_shapes_and_errors(run):
    for r in run["ranks"]:
        assert r["shapes"] == [{"ant": 4, "time": 1}, {"ant": 2, "time": 2},
                               {"ant": 3, "time": 1}, {"ant": 2, "time": 2}]
        assert r["error"] == "mesh 3x2 > 4 devices"


@pytest.mark.parametrize("which", ["halo_next", "halo_prev"])
def test_halo_exchange_equals_jax(run, which):
    got = np.stack([r[which] for r in run["ranks"]])
    np.testing.assert_array_equal(got, run["jax"][which])


def test_coadd_psum_equals_jax(run):
    for r, want in zip(run["ranks"], run["jax"]["coadd_psum"][[0, 0, 1, 1]]):
        np.testing.assert_allclose(r["coadd_psum"], want, rtol=1e-6)


def test_sharded_coherent_equals_jax(run):
    """The port departs from the JAX package where their future halos
    differ (#7: the port takes the next shard's own head, the JAX package
    this shard's own tail): every shard but the last, whose future halo
    is zeros in both and whose output stays equal.  The JAX test's
    round-trip bar holds away from the stream's edges."""
    got = np.concatenate([r["coherent"] for r in run["ranks"]], axis=1)
    want = run["jax"]["coherent"]
    rms = np.sqrt(np.mean(want ** 2))
    span = COH["nsamp"] // WORLD
    last = slice((WORLD - 1) * span, None)
    assert np.abs(got[:, last] - want[:, last]).max() <= 1e-4 * rms
    for i in range(WORLD - 1):
        shard = slice(i * span, (i + 1) * span)
        assert np.abs(got[:, shard] - want[:, shard]).max() > 1e-2 * rms
    # the JAX test's round-trip bar away from the stream's edges
    from vlite_fast_tpu_torch.parallel.sharded_coherent import sharded_halo
    halo = sharded_halo(COH["dm"], COH["rate"], COH["bw"], COH["fbot"])
    x = run["x"]
    err = np.abs(got[:, 2 * halo:-2 * halo] - x[:, 2 * halo:-2 * halo])
    assert err.max() < 0.1 and np.median(err) < 2e-3
    assert (err > 0.01).mean() < 0.01


def _no_history_topk(fb, skip, plan, info, scfg, ntime_out, k):
    """A window's crossings when its first `skip` outputs lie before the
    stream's first sample: the rows from the first real one searched at
    their own length, the outputs before it S/N 0."""
    from vlite_fast_tpu_torch.models import search as tsearch
    from vlite_fast_tpu_torch.ops import dedisperse as tdd
    snr = torch.zeros((len(info.widths), len(info.dms), ntime_out))
    if skip < ntime_out:
        dmt = tsearch.dedisperse(
            fb[skip:], plan, ntime_out - skip,
            engine=tsearch.resolve_engine(scfg.engine, "cpu"))
        snr[:, :, skip:] = tdd.boxcar_snr(dmt, plan.nchan_eff, info.widths)
    return tsearch.pack_topk_banded(snr, k, info.nbands,
                                    float(scfg.snr_thresh))


def _mesh_reference(packed, tail_in, info, plan, acfg):
    """The (beam_topk, coadd_topk) a mesh of info's shape computes, from
    the one-rank run's packed stream and the call's input tail, in one
    process: the reshard, the halos and the coadd's sum spelled out.
    tail_in None is an observation's first call: time chunk 0 has no
    history, and its windows' outputs before sample 0 are not searched
    (_no_history_topk; the rows standing in for the history are zeros,
    read by nothing that is kept)."""
    from vlite_fast_tpu_torch.parallel.sharded_pipeline import (
        dequant_rows, search_topk)
    cfg, scfg = acfg.pipeline, acfg.search
    c, halo, mg, ntblk = info.c, info.halo, info.mg, info.ntblk
    btk, coadd = [], {}
    for d in range(info.na * ntblk):
        a, t = divmod(d, ntblk)
        rows = []
        for j in range(mg):                 # beam a*mg + j is antenna a*mg + j
            s = packed[a * mg + j]
            prev = (s[t * c - halo:t * c] if t else
                    np.zeros_like(s[:halo]) if tail_in is None
                    else tail_in[a * mg + j])
            fb = dequant_rows(torch.from_numpy(np.concatenate(
                [prev, s[t * c:(t + 1) * c]])), cfg)
            rows.append(
                _no_history_topk(fb, halo, plan, info, scfg, c, info.k_beam)
                if t == 0 and tail_in is None else
                search_topk(fb, plan, info, scfg, c, info.k_beam))
            co = fb if j == 0 else co.add_(fb)
        btk.append(torch.stack(rows).numpy())
        coadd[(a, t)] = co
    ctk = []
    for d in range(info.na * ntblk):
        a, t = divmod(d, ntblk)
        co = coadd[(0, t)].clone()
        for a2 in range(1, info.na):
            co += coadd[(a2, t)]
        co.mul_(float(np.float32(1.0 / np.sqrt(info.nant))))
        start = a * info.ca if info.coadd_split else 0
        win = co[start:start + info.ca + halo]
        ctk.append((_no_history_topk(win, max(0, halo - start), plan, info,
                                     scfg, info.ca, info.k_co)
                    if t == 0 and tail_in is None else
                    search_topk(win, plan, info, scfg, info.ca,
                                info.k_co)).numpy())
    return np.stack(btk), np.stack(ctk)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{a}x{t}" for a, t in MESHES])
def test_array_step_meshes_byte_identical(run, mesh):
    """Every mesh's DSP bytes, weights and carried state equal the 1x1
    run's; its per-beam and coadd crossings equal the single-process
    reference of its reshard from the 1x1 run's stream, on the first
    call (make_inputs: no history)."""
    steps = run["ranks"][0]["step"]
    one, one_state = steps[(1, 1)][0][0]
    calls, info, plan = steps[mesh]
    out, state = calls[0]
    np.testing.assert_array_equal(out.packed_kur, one.packed_kur)
    np.testing.assert_array_equal(out.weights_mean, one.weights_mean)
    for a, b in zip(state, one_state):
        np.testing.assert_array_equal(a, b)
    btk, ctk = _mesh_reference(one.packed_kur, None, info, plan,
                               _port_acfg(run["acfg"]))
    np.testing.assert_array_equal(out.beam_topk, btk)
    np.testing.assert_array_equal(out.coadd_topk, ctk)


def test_array_step_second_call_as_before(run):
    """The 2x2 mesh's second call, from the JAX step's state (a tail of
    history): its crossings are the reference's with that tail, bit for
    bit, as every call with a tail has always been searched."""
    calls, info, plan = run["ranks"][0]["step"][(2, 2)]
    out, _ = calls[1]
    btk, ctk = _mesh_reference(out.packed_kur, run["jax"]["calls"][0][1][2],
                               info, plan, _port_acfg(run["acfg"]))
    np.testing.assert_array_equal(out.beam_topk, btk)
    np.testing.assert_array_equal(out.coadd_topk, ctk)


def _levels(packed, nbit):
    from vlite_fast_tpu.ops.quantize import unpack_bits
    return np.asarray(unpack_bits(packed, nbit))


def _shard_hits(out, info, thresh):
    """{("beam", d, j) or ("coadd", d): sorted (dmi, sample, width, S/N)}
    of every shard's crossings above thresh, the sample absolute in the
    call's output stream (extract_candidates' mapping)."""
    from vlite_fast_tpu_torch.models.search import decode_crossings
    nw, ndm = len(info.widths), len(info.dms)
    got = {}
    for d in range(out.beam_topk.shape[0]):
        a, t = divmod(d, info.ntblk)
        base = t * info.c - info.halo
        shards = [(("beam", d, j), out.beam_topk[d, j], info.c, base)
                  for j in range(info.mg)]
        shards.append((("coadd", d), out.coadd_topk[d], info.ca,
                       base + a * info.ca if info.coadd_split else base))
        for key, packed, ntime, b in shards:
            vals, hits, _, _ = decode_crossings(packed, nw, ndm, ntime,
                                                info.nbands, thresh)
            got[key] = sorted((int(h[1]), int(h[2]) + b, int(h[0]), float(v))
                              for h, v in zip(hits, vals))
    return got


@pytest.mark.parametrize("call", [0, 1])
def test_array_step_against_jax(run, call):
    """The 2x2 port step against the JAX package's 2x2 step: call 0 from
    make_inputs (the JAX step's zero bandpasses replaced by the port's
    seed, _port_seed), call 1 continuing the JAX step's state
    (interop.array_state_from_jax) on fresh noise.  Call 0 departs in
    time chunk 0 alone (#6): the JAX step's make_inputs gives it `halo`
    rows of random bytes before sample 0, whose outputs it searches and
    reports; the port's gives no history, and its chunk-0 searches report
    nothing before sample 0.  Every other shard's crossings are the JAX
    step's."""
    from vlite_fast_tpu.parallel.sharded_pipeline import (
        ArrayStepOutput, extract_candidates)
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as tsp
    (out, state), info = (run["ranks"][0]["step"][(2, 2)][0][call],
                          run["ranks"][0]["step"][(2, 2)][1])
    jout, jstate = run["jax"]["calls"][call]
    nbit = run["acfg"].pipeline.nbit
    agree = (_levels(out.packed_kur, nbit)
             == _levels(jout.packed_kur, nbit)).mean()
    assert agree >= 0.9999, agree
    for got, want in zip(state[:2], jstate[:2]):       # bp, bp_kur
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (out.packed_kur[:, -info.halo:] == state[2]).all()
    np.testing.assert_allclose(out.weights_mean, jout.weights_mean,
                               rtol=1e-6)
    scfg = run["acfg"].search
    if call == 0:
        got = _shard_hits(out, info, scfg.snr_thresh)
        want = _shard_hits(ArrayStepOutput(*jout), info, scfg.snr_thresh)
        assert sorted(got) == sorted(want)
        for key in want:
            t = key[1] % info.ntblk
            if t:
                assert [h[:3] for h in got[key]] == \
                    [h[:3] for h in want[key]], key
                np.testing.assert_allclose([h[3] for h in got[key]],
                                           [h[3] for h in want[key]],
                                           rtol=1e-3)
            else:
                assert all(h[1] >= 0 for h in got[key]), key
        assert any(h[1] < 0 for key in want if key[1] % info.ntblk == 0
                   for h in want[key])
        return
    got_b, got_c, _ = tsp.extract_candidates(out, info, _port_acfg(
        run["acfg"]).search)
    want_b, want_c, _ = extract_candidates(ArrayStepOutput(*jout),
                                           run["jax"]["info"], scfg)
    assert sorted(got_b) == sorted(want_b) == list(range(4))
    for got, want in [(got_b[b], want_b[b]) for b in want_b] + \
            [(got_c, want_c)]:
        assert [(c.dmi, c.peak_idx) for c in got] == \
            [(c.dmi, c.peak_idx) for c in want]
        np.testing.assert_allclose([c.snr for c in got],
                                   [c.snr for c in want], rtol=1e-3)


@pytest.mark.parametrize("world", [1, WORLD])
def test_dryrun_multichip(run, world):
    got = run["ranks"][0]["dryrun"][world]
    assert got["n_beams"] == got["beams_with_cands"] == world
    assert abs(got["coadd_best_dm"] - 300.0) < 40.0
    assert got["mesh"] == ({"ant": 2, "time": 2} if world == WORLD
                           else {"ant": 1, "time": 1})
    # the mesh's other ranks return the same summary; ranks outside, None
    for r in run["ranks"][1:]:
        assert r["dryrun"][world] == (got if world == WORLD else None)


def test_fullgeom_initial_state_is_a_warmup_observation():
    """benchmarks/fullgeom_mesh starts the first call mid-observation: each
    antenna's noise of the seconds before it through process_second, its
    bandpasses and its last halo packed rows."""
    import types

    from vlite_fast_tpu_torch.benchmarks import fullgeom_mesh as fg
    from vlite_fast_tpu_torch.config import PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    cfg = PipelineConfig.tiny(nbit=2)
    mesh = types.SimpleNamespace(d=1, device=torch.device("cpu"))
    info = types.SimpleNamespace(m=2, halo=700)     # 500 rows a second
    bp, bpk, tail = fg.initial_state(mesh, cfg, info, seed=3)
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    assert tail.shape == (2, 700, nbytes) and tail.dtype == torch.uint8
    for i in range(2):
        gen = fg._gen(mesh.device, 3, -1, 2 + i)       # antennas 2 and 3
        st, rows = dsp.init_state(cfg, "cpu"), []
        for _ in range(2):
            o, st = dsp.process_second(
                cfg, fg.noise_second(gen, 2, cfg.sample_rate, "cpu"), st)
            rows.append(o.packed_kur)
        assert torch.equal(tail[i], torch.cat(rows)[-700:])
        assert torch.equal(bp[i], st.bp) and torch.equal(bpk[i], st.bp_kur)


def test_fullgeom_judge():
    """The report's verdict: every beam and the coadd near the injected
    DM, and the coadd above the best beam."""
    import types

    from vlite_fast_tpu_torch.benchmarks.fullgeom_mesh import judge
    from vlite_fast_tpu_torch.ops.dedisperse import Candidate
    info = types.SimpleNamespace(dms=tuple(np.linspace(2.0, 1000.0, 1024)),
                                 nant=2)

    def cand(snr, dm):
        return Candidate(snr, 10, 0.01, 0, 0, dm, 1, 9, 11)
    beams = {0: [cand(20.0, 80.5), cand(30.0, 2.0)], 1: [cand(22.0, 79.2)]}
    got = judge(beams, [cand(40.0, 80.0)], info, 80.0)
    assert got["pass"] and got["beams"]["0"]["snr"] == 20.0
    assert got["coadd"]["gain_vs_best_beam"] == pytest.approx(40.0 / 22.0)
    assert not judge(beams, [cand(21.0, 80.0)], info, 80.0)["pass"]
    assert not judge({0: beams[0]}, [cand(40.0, 80.0)], info, 80.0)["pass"]
    far = judge({0: [cand(20.0, 90.0)], 1: beams[1]}, [cand(40.0, 80.0)],
                info, 80.0)
    assert not far["pass"] and not far["beams"]["0"]["recovered"]


# Faults the port shared with, or finds in, the reference (ROADMAP Queue 3
# #6-#8): each test measures the fault in the JAX package, and where the
# port repairs it (#6, #7), the port's departure.

def test_first_call_history_steps_from_the_data():
    """#6: the JAX step's make_inputs history for the first call (uniform
    random bytes) dequantizes at 2 bits to a mean of ~0.36, where the
    chain's rows of noise average ~-0.04: summed over the channels, a
    step at the stream's head."""
    from vlite_fast_tpu_torch.config import PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.ops import quantize as q
    cfg = PipelineConfig.tiny(nbit=2)
    rng = np.random.default_rng(0)
    st, rows = dsp.init_state(cfg, "cpu"), []
    for _ in range(3):
        raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                      + 128.5, 0, 255).astype(np.uint8)
        o, st = dsp.process_second(cfg, torch.from_numpy(raw), st)
        rows.append(o.packed_kur)
    data = float(q.dequantize(torch.cat(rows[1:]), 2).mean())
    history = float(q.dequantize(torch.from_numpy(rng.integers(
        0, 256, (1000, rows[0].shape[1]), dtype=np.uint8)), 2).mean())
    assert abs(data + 0.04) < 0.02 and abs(history - 0.36) < 0.02


@pytest.mark.parametrize("start", ["history", "warm"])
def test_first_call_2bit_as_jax(run, start):
    """#6 at 2 bits (_acfg_2bit, 1x1).  From make_inputs the JAX step
    searches its random-byte history, saturates DM bands and loses the
    burst; the port's make_inputs gives no history, and its step
    saturates none and keeps the burst in every beam and in the coadd.
    From fullgeom_mesh.initial_state's warm-up both keep it, with the
    same candidates."""
    from vlite_fast_tpu.parallel.sharded_pipeline import (
        ArrayStepOutput, extract_candidates)
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as tsp
    acfg = _acfg_2bit()
    outs, info = run["ranks"][0]["2bit"]
    jouts, jinfo = run["jax"]["2bit"]
    got_b, got_c, got_s = tsp.extract_candidates(
        outs[start], info, _port_acfg(acfg).search)
    want_b, want_c, want_s = extract_candidates(
        ArrayStepOutput(*jouts[start]), jinfo, acfg.search)
    dm = acfg.pipeline.inject_dm

    def keeps_the_burst(beams, coadd):
        assert sorted(beams) == list(range(acfg.nant))
        for cands in list(beams.values()) + [coadd]:
            assert abs(max(cands, key=lambda c: c.snr).dm - dm) < 5.0
    if start == "history":
        assert want_s["saturated_bands"] > 0
        assert not want_b and not want_c
        assert got_s["saturated_bands"] == 0
        keeps_the_burst(got_b, got_c)
        return
    assert got_s["saturated_bands"] == want_s["saturated_bands"] == 0
    assert abs(got_s["n_crossings"] - want_s["n_crossings"]) \
        <= 1e-3 * want_s["n_crossings"]
    assert sorted(got_b) == sorted(want_b)
    for got, want in [(got_b[b], want_b[b]) for b in want_b] + \
            [(got_c, want_c)]:
        assert [(c.dmi, c.peak_idx) for c in got] == \
            [(c.dmi, c.peak_idx) for c in want]
        np.testing.assert_allclose([c.snr for c in got],
                                   [c.snr for c in want], rtol=1e-3)
    keeps_the_burst(want_b, want_c)


def test_first_call_from_zero_bandpasses_as_a_warm_start(run):
    """#2 in the sharded step (_acfg_2bit, 1x1).  From zero bandpasses the
    port's first call seeds them (seed_bandpass) and reads as a warm
    start: no saturated DM band, crossings within 1.5x of the warm-up's,
    the burst in every beam and in the coadd.  The JAX step from zero
    bandpasses (with the warm-up's history, so its random bytes play no
    part) seeds each from its first tile: at this geometry it saturates
    no band either (chip_smoke [18a] counted four at the reference
    geometry, PERF.md section 6), but the start-up transient lifts every
    DM's noise, so it
    counts fewer than 3/4 of its warm start's crossings, and its coadd's
    burst reads lower."""
    from vlite_fast_tpu.parallel.sharded_pipeline import (
        ArrayStepOutput, extract_candidates)
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as tsp
    acfg = _acfg_2bit()
    outs, info = run["ranks"][0]["2bit"]
    jouts, jinfo = run["jax"]["2bit"]
    port = {k: tsp.extract_candidates(outs[k], info,
                                      _port_acfg(acfg).search)
            for k in ("history", "warm")}
    jax_ = {k: extract_candidates(ArrayStepOutput(*jouts[k]), jinfo,
                                  acfg.search)
            for k in ("zero", "warm")}
    dm = acfg.pipeline.inject_dm
    best = lambda cands: max(cands, key=lambda c: c.snr)
    cold, warm = port["history"], port["warm"]
    assert cold[2]["saturated_bands"] == 0
    ratio = cold[2]["n_crossings"] / warm[2]["n_crossings"]
    assert 1 / 1.5 <= ratio <= 1.5, ratio
    assert sorted(cold[0]) == list(range(acfg.nant))
    for cands in list(cold[0].values()) + [cold[1]]:
        assert abs(best(cands).dm - dm) < 5.0
    assert best(cold[1]).snr >= 0.95 * best(warm[1]).snr
    jz, jw = jax_["zero"], jax_["warm"]
    assert jz[2]["n_crossings"] < 0.75 * jw[2]["n_crossings"]
    assert best(jz[1]).snr < 0.9 * best(jw[1]).snr


def test_sharded_coherent_future_halo_is_the_shards_own_past(run):
    """#7: the JAX package's sharded chirp prepends the previous shard's
    tail, then takes its 'next' halo from the next shard's extended block,
    whose head is this shard's own tail.  The port takes the next shard's
    own head: its output is this test's [prev tail, shard, next head]
    construction to 1e-5 of the signal's rms (float32 FFTs of the same
    block), and the JAX package's round-trip error stays more than 5x the
    construction's."""
    from vlite_fast_tpu_torch.ops import coherent as coh
    from vlite_fast_tpu_torch.parallel.sharded_coherent import sharded_halo
    n, x = COH["nsamp"], run["x"]
    halo = sharded_halo(COH["dm"], COH["rate"], COH["bw"], COH["fbot"])
    ker = coh.dispersion_kernel(n, COH["dm"], COH["bw"], COH["fbot"],
                                taper=False, device="cpu")
    d = coh.apply_chirp(torch.from_numpy(x), ker)
    span = n // WORLD
    zeros = torch.zeros((2, halo))
    outs = []
    for i in range(WORLD):
        prev = d[:, i * span - halo:i * span] if i else zeros
        nxt = d[:, (i + 1) * span:(i + 1) * span + halo] \
            if i < WORLD - 1 else zeros
        block = torch.cat([prev, d[:, i * span:(i + 1) * span], nxt], dim=1)
        outs.append(coh.coherent_dedisperse(
            block, COH["dm"], COH["rate"], COH["bw"],
            COH["fbot"])[:, halo:halo + span])
    fixed = torch.cat(outs, dim=1).numpy()
    got = np.concatenate([r["coherent"] for r in run["ranks"]], axis=1)
    rms = np.sqrt(np.mean(fixed ** 2))
    assert np.abs(got - fixed).max() <= 1e-5 * rms
    inner = slice(2 * halo, n - 2 * halo)
    err_jax = np.abs(run["jax"]["coherent"][:, inner] - x[:, inner]).max()
    err_fixed = np.abs(fixed[:, inner] - x[:, inner]).max()
    assert err_jax > 5 * err_fixed, (err_jax, err_fixed)


def test_jax_assoc_ema_departs_under_clipped_burst():
    """#8: at arraystep_config's geometry with the FRB at amplitude 3, the
    JAX 'assoc' EMA's armed second departs from its sequential 'scan'
    (which the port matches bit for bit) where the kurtosis bandpass
    clips: more than 0.5% of the 8-bit levels."""
    import jax.numpy as jnp

    from vlite_fast_tpu.models import baseband_dsp as jdsp
    from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
    cfg = _acfg().pipeline
    rng = np.random.default_rng(SEED)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    outs = {}
    for impl in ("assoc", "scan"):
        c = dataclasses.replace(cfg, ema_impl=impl)
        o, _ = jdsp.process_second(c, jnp.asarray(raw), jdsp.init_state(c),
                                   jnp.bool_(True))
        outs[impl] = np.asarray(o.packed_kur)
    port, _ = tdsp.process_second(_port_acfg(_acfg()).pipeline,
                                  torch.from_numpy(raw),
                                  tdsp.init_state(_port_acfg(
                                      _acfg()).pipeline, "cpu"), True)
    np.testing.assert_array_equal(port.packed_kur.numpy(), outs["scan"])
    assert (outs["assoc"] != outs["scan"]).mean() > 0.005

