"""What the readers of the array step's call records share: the
window's call records (drivers/array_step.Run.calls, utils/spans records
of layer "call"), none where the program keeps no call records (before
the array step took them), and the reader then reads no value."""

import numpy as np

# process_second's device stages (models/baseband_dsp)
DSP_STAGES = ("front", "wola", "dft", "detect", "ema", "pack")
BEAM_STAGES = ("dedisperse", "boxcar", "topk")
COADD_STAGES = ("coadd", "coadd_search")


def median(run, per_call):
    """The median over the window's call records of per_call(record);
    None without a record."""
    v = [per_call(r) for r in getattr(run, "calls", ())]
    return float(np.median(v)) if v else None


def stages_s(rec, names) -> float:
    """Seconds of the record's device stages `names`."""
    return sum(rec.stages.get(n, 0.0) for n in names)
