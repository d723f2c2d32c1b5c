"""The device an entry point runs on.

Every entry point of the port (StationPipeline, SinglePulseSearch,
baseband_dsp.init_state, dedisperse.make_plan, interop's state_from_jax
and plan_from_jax) takes `device="cuda"` unless told otherwise: the port
is written for the card.  Without one it raises here; it never falls back
to the CPU.  The CPU is a choice the caller makes (device="cpu"), as the
tests do.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device(device), raising if it names CUDA and there is no card.
    A card named without an index gets the current one ('cuda' ->
    'cuda:0'), the device of the tensors made on it, so that a tensor's
    device compares equal to the entry point's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
