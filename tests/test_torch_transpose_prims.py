"""The port's tile_bench (vlite_fast_tpu_torch/benchmarks/transpose_prims)
against the TPU kernel of benchmarks/bench_transpose_prims_tpu.py, on the
CPU.

The script runs its benchmark when imported, so its _tile_kernel is taken
from its source with ast and run through pl.pallas_call in interpret mode
(NB = 4 tiles, 2 grid steps).  Bars: 'none' and 'xlu' exact (the same f32
adds in the same order); 'mxu' within 1e-6 relative (a bf16 identity
product: the tile rounded to bf16, which XLA may round at another place).
"""

import ast
import functools
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp

torch.set_num_threads(1)

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
    "bench_transpose_prims_tpu.py"
NB = 4
STEPS = 2


def _tile_kernel(nb: int):
    """_tile_kernel of the script, its globals bound to jax, jnp, pl,
    LANE = 128 and NB = nb."""
    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_tile_kernel")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "LANE": tp.LANE, "NB": nb}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    return ns["_tile_kernel"]


def _tpu_tile_bench(x: np.ndarray, impl: str, nb: int, steps: int):
    """The script's tile_bench call on x, in interpret mode."""
    lane = tp.LANE
    return np.asarray(pl.pallas_call(
        functools.partial(_tile_kernel(nb), impl=impl),
        grid=(steps,),
        in_specs=[pl.BlockSpec((nb * lane, lane), lambda i: (0, 0)),
                  pl.BlockSpec((lane, lane), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((lane, lane), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((lane, lane), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.eye(lane, dtype=jnp.float32)))


def _input(nb: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (nb * tp.LANE, tp.LANE)).astype(np.float32)


@pytest.mark.parametrize("impl", tp.IMPLS)
def test_tile_sum_matches_tpu_kernel(impl):
    x = _input(NB)
    want = _tpu_tile_bench(x, impl, NB, STEPS)
    got = tp.tile_sum(torch.from_numpy(x), impl).numpy()
    assert tp.LAUNCHES == 0                   # CPU: the plain version
    if impl == "mxu":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("impl", tp.IMPLS)
def test_tile_sum_matches_tpu_kernel_at_nb(impl, nb):
    """One tile and an odd number of tiles (the CUDA tests' nb 1 and 3),
    at the same bars."""
    x = _input(nb, seed=nb)
    want = _tpu_tile_bench(x, impl, nb, STEPS)
    got = tp.tile_sum(torch.from_numpy(x), impl).numpy()
    if impl == "mxu":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(got, want)


def test_tile_sum_modes_relate():
    """'xlu' is 'none' of the transposed tiles; 'mxu' is 'xlu' of the
    bf16-rounded input."""
    x = torch.from_numpy(_input(3, seed=2))
    tiles_t = x.reshape(3, tp.LANE, tp.LANE).transpose(1, 2).reshape(x.shape)
    assert torch.equal(tp.tile_sum(x, "xlu"),
                       tp.tile_sum(tiles_t.contiguous(), "none"))
    xr = x.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tp.tile_sum(x, "mxu"), tp.tile_sum(xr, "xlu"))
    with pytest.raises(ValueError, match="impl"):
        tp.tile_sum(x, "vpu")


def test_tile_bench_entry_on_cpu(capsys):
    """tile_bench draws the script's input from rng (its default: numpy
    default_rng(7)) and, on the CPU, runs the plain version untimed."""
    x, got, ms = tp.tile_bench("xlu", device="cpu",
                               rng=np.random.default_rng(7))
    want = np.random.default_rng(7).standard_normal(
        (tp.NB * tp.LANE, tp.LANE)).astype(np.float32)
    assert np.array_equal(x.numpy(), want) and ms is None
    assert torch.equal(got, tp.tile_sum_plain(x, "xlu"))
    assert "not timed" in capsys.readouterr().out


def test_tile_sum_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2 * tp.LANE, tp.LANE))
    for bad in (x.double(), x[:100], x[:, :64].contiguous(), x.t(),
                x[:0], x.reshape(-1)):
        with pytest.raises(ValueError, match="x must be"):
            tp.tile_sum(bad, "none")
    with pytest.raises(ValueError, match="reps"):
        tp.tile_sum(x, "none", reps=0)
