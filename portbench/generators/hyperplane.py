"""The rotating-hyperplane stream (Hulten, Spencer and Domingos, KDD 2001),
as MOA's ``HyperplaneGenerator`` draws it, on the card from the seed.

A traffic mix gives the ring's ``segments``: each a number of batches
and the concept they follow. A concept is a weight vector, each weight
uniform in [0, 1); an event's features are uniform in [0, 1), its label
1 where the weighted sum reaches half the weights' sum, flipped with
probability ``noise`` (MOA's ``noisePercentage``). The ring is made once
in set-up, on the card in a few large calls, then copied into pageable
host memory, where a receiver would hold it; the job replays it in
order.
"""

from __future__ import annotations

import torch


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & ((1 << 63) - 1))
    return g


def ring(mix: dict, cfg: dict, seed: int, device) -> list:
    """The ring's batches (``StreamBatch``, host tensors ``x`` (n, d) fp32
    and ``y`` (n,) int32), in the order the job sees them."""
    from repro_torch.streams.events import StreamBatch
    d, n = cfg["num_features"], cfg["batch_events"]
    g = _generator(seed, 0, device)
    n_concepts = 1 + max(s["concept"] for s in mix["segments"])
    weights = torch.rand((n_concepts, d), generator=g, device=device)
    out = []
    for seg in mix["segments"]:
        w = weights[seg["concept"]]
        for _ in range(seg["batches"]):
            x = torch.rand((n, d), generator=g, device=device)
            flip = torch.rand((n,), generator=g, device=device) < mix["noise"]
            y = ((x * w).sum(1) >= 0.5 * w.sum()) ^ flip
            out.append(StreamBatch(data={"x": x.cpu(),
                                         "y": y.to(torch.int32).cpu()},
                                   seq_no=len(out)))
    return out
