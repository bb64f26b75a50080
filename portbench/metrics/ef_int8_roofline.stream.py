"""ef_int8_roofline.stream: the int8 EF round-trips' share of their
roofline, in %: the least time the card could take for the window's
round-trips (each fp32 input read once and each output written once,
16 bytes an element, at the card's published HBM rate) over the device
time of the codec's kernels in the trace."""

import torch

from portbench import arith, kernels


def read(run):
    if not str(run.device).startswith("cuda"):
        return None
    t, elems = run.trace, run.work.get("codec_elements", 0)
    if t is None or not elems:
        return None
    spent = t.seconds(kernels.is_codec)
    if spent <= 0:
        return None
    bw = arith.card_peaks(torch.cuda.get_device_name(0))["bytes_per_s"]
    return 100.0 * arith.ef_int8_bound_s(elems, bw) / spent
