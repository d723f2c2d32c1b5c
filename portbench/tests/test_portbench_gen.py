"""The traffic generators are found by name, seeded and deterministic,
and the pulsar's pulses land at their period."""

import copy
import json

import pytest
import torch

from portbench import spec
from portbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 12345          # more than 32 signed bits hold
MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))


def _load(name):
    return json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())


def _staged(traffic, seed):
    cell = tiny_cell()
    return spec.generator(traffic).staged_seconds(
        traffic, cell.config["dsp"], seed, "cpu")


@pytest.mark.parametrize("name", MIXES)
def test_seeded_and_deterministic(name):
    t = _load(name)
    a, b, c = _staged(t, SEED), _staged(t, SEED), _staged(t, SEED + 1)
    assert len(a) == t["seconds"]
    assert a[0].shape == (2, 1_000_000) and a[0].dtype == torch.uint8
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_noise_is_the_digitizer_level():
    x = torch.cat(_staged(_load("noise"), SEED), dim=1).float()
    # unit noise at 1 / 0.05914 counts about 128.5, truncated
    assert abs(x.mean().item() - 128.0) < 0.05
    assert abs(x.std().item() - 1 / 0.05914) < 0.05


def test_pulsar_pulses_land_at_their_period():
    t = copy.deepcopy(_load("pulsar"))
    t["pulsar"]["dm"] = 0.0          # undispersed: the windows stay put
    t["pulsar"]["amp"] = 0.5
    x = torch.cat(_staged(t, SEED), dim=1).float() - 128.0
    power = (x * x).mean(dim=0)
    rate = 1_000_000
    period = int(t["pulsar"]["period_s"] * rate)
    on = int(t["pulsar"]["duty"] * period)
    folded = power.reshape(-1, period).mean(dim=0)
    # the band taper spreads a window's edges by a few samples only
    inside = folded[50:on - 50].mean()
    outside = folded[on + 50:].mean()
    assert inside / outside > 1.5 ** 2 * 0.9
