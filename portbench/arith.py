"""The yardstick's arithmetic: the card's published peaks, the bytes the
int8 error-feedback codec must move, and a decoder's FLOPs a token.

Copied from ``chip_smoke.py`` (``CARD_PEAKS``, the codec's 16 bytes an
element, MFU's 6N) and kept here, where a change to the program cannot
move it.
"""

from __future__ import annotations

# HBM bytes/s, fp32 (non-tensor) flop/s and dense bf16 tensor-core
# flop/s by card, from NVIDIA's data sheets (dense rates, no sparsity);
# matched on the name ``torch.cuda.get_device_name`` gives, first match
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),          # SXM, "H100 80GB HBM3"
)


def card_peaks(name: str) -> dict:
    """``{"bytes_per_s", "fp32_flops", "bf16_flops"}`` of the card named
    ``name``; a card not in the table has no peaks (KeyError)."""
    for key, bw, fp32, bf16 in CARD_PEAKS:
        if key in name:
            return {"bytes_per_s": bw, "fp32_flops": fp32, "bf16_flops": bf16}
    raise KeyError(f"no published peaks for card {name!r}")


# the int8 EF round-trip reads x and the residual and writes the decoded
# value and the new residual, 4 bytes each, once per element
EF_INT8_BYTES_PER_ELEMENT = 16


def ef_int8_bound_s(elements: int, bytes_per_s: float) -> float:
    """The least time the card could take for round-trips over
    ``elements`` fp32 elements in all: bytes over the HBM peak."""
    return EF_INT8_BYTES_PER_ELEMENT * elements / bytes_per_s


def decoder_matmul_params(d_model: int, n_layers: int, n_heads: int,
                          n_kv_heads: int, d_head: int, d_ff: int,
                          vocab: int) -> int:
    """Parameters that take part in a matrix product a token: the
    attention projections and the gated MLP of every layer, and the
    vocabulary head once (a tied embedding's lookup is no product)."""
    attn = d_model * (n_heads + 2 * n_kv_heads) * d_head \
        + n_heads * d_head * d_model
    mlp = 3 * d_model * d_ff
    return n_layers * (attn + mlp) + vocab * d_model


def decoder_train_flops_per_token(d_model: int, n_layers: int, n_heads: int,
                                  n_kv_heads: int, d_head: int, d_ff: int,
                                  vocab: int, seq_len: int) -> float:
    """Model FLOPs of a training step a token (forward and backward, no
    recomputation): 6 per matmul parameter, plus causal attention's
    score and value products, 12 x layers x heads x head dim x the mean
    number of positions a token attends, (S + 1) / 2."""
    n = decoder_matmul_params(d_model, n_layers, n_heads, n_kv_heads,
                              d_head, d_ff, vocab)
    attended = (seq_len + 1) / 2.0
    return 6.0 * n + 12.0 * n_layers * n_heads * d_head * attended
