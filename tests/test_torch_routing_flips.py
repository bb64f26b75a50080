"""``chip_smoke.py``'s bf16 routing check of phase 18e-18f
(``routing_flips``) and the token check it feeds (``tie_divergences``),
on recorded layers made by hand: a flip whose logit gap lies within the
largest move of a logit gap on the layer's unreached agreeing tokens or
of the token's other experts passes and marks its row downstream, one
past both fails, a keep mask that moves with no flip fails, a
difference reaches only the later positions of its row in the prefill
and every later step, and a token may part only at a logit tie or
downstream of a flip; and the step logits check of ``tp_bf16_checks``:
each step's logits held on the rows whose tokens agree up to it, a
step that holds no row failing."""

import math
import pathlib
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

B, S, K, E = 2, 4, 2, 4


def _layer(probs):
    """A RoutingRecorder layer from (tokens, E) probabilities: top-K ids
    as ``moe.top_k`` takes them, every assignment kept, the dispatch's
    stable sort by expert."""
    probs = torch.tensor(probs, dtype=torch.float32)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        :, :K]
    order = torch.argsort(ids.reshape(-1), stable=True)
    return {"ids": ids, "probs": probs, "near": torch.zeros(len(probs),
                                                            dtype=torch.bool),
            "keep": torch.ones(len(order), dtype=torch.bool), "order": order}


BASE = [0.4, 0.3, 0.2, 0.1]


def _run(prefill_one, prefill_rank, decode_one=None, decode_rank=None,
         got=None, want=None):
    decode_one = decode_one or [BASE] * B
    decode_rank = decode_rank or decode_one
    want = want if want is not None else torch.zeros((B, 2), dtype=torch.long)
    got = got if got is not None else want.clone()
    return cs.routing_flips([_layer(prefill_one), _layer(decode_one)],
                            [_layer(prefill_rank), _layer(decode_rank)],
                            got, want, K, "test")


@pytest.fixture(autouse=True)
def _one_decode(monkeypatch):
    monkeypatch.setattr(cs, "SHARD_DECODES", 1)


def test_a_flip_within_the_bound_marks_its_row_downstream():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    rank[0] = [0.4, 0.3001, 0.2, 0.0999]          # gaps move by 1.33e-3
    one[6] = [0.4, 0.2501, 0.25, 0.0999]          # row 1, position 2
    rank[6] = [0.4, 0.25, 0.2501, 0.0999]         # the K-th flips
    flips, down, bound, by_layer = _run(one, rank)
    assert by_layer == [1]
    (step, layer, row, pos, gap, own, reached), = flips
    assert (step, layer, row, pos, own, reached) == (0, 0, 1, 2, 0.0, False)
    assert gap == pytest.approx(math.log(0.2501 / 0.25), rel=1e-3)
    assert bound[0] == pytest.approx(math.log(0.3001 / 0.3)
                                     - math.log(0.0999 / 0.1), rel=1e-3)
    assert down == [None, 0]


def test_a_flip_past_the_bound_fails():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    one[6] = [0.4, 0.2501, 0.25, 0.0999]
    rank[6] = [0.4, 0.25, 0.2501, 0.0999]          # no agreeing token moved
    with pytest.raises(AssertionError, match="logit gap"):
        _run(one, rank)


def test_a_flip_within_its_tokens_own_moves_passes():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    one[6] = [0.4, 0.2501, 0.25, 0.0999]
    rank[6] = [0.4002, 0.25, 0.2501, 0.0998]      # its other gaps moved
    (*_, gap, own, reached), = _run(one, rank)[0]
    assert gap <= own and not reached


def test_a_flip_reaches_the_later_positions_and_steps_of_its_row():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    rank[0] = [0.4, 0.3001, 0.2, 0.0999]
    one[5] = [0.4, 0.2501, 0.25, 0.0999]          # row 1, position 1
    rank[5] = [0.4, 0.25, 0.2501, 0.0999]
    # at the decode step row 1 routes elsewhere, far from any tie
    decode_rank = [BASE, [0.1, 0.2, 0.3, 0.4]]
    flips, down, _, by_layer = _run(one, rank, decode_rank=decode_rank)
    assert by_layer == [2]
    assert flips[-1][:4] == (1, 0, 1, S) and flips[-1][6]
    # row 0, unreached, may not swap its two largest while no other
    # logit gap of it moves
    with pytest.raises(AssertionError, match="step 1 layer 0 row 0"):
        _run(one, rank, decode_rank=[[0.3, 0.4, 0.2, 0.1], BASE])


def test_a_parted_token_reaches_the_next_step():
    one = [BASE] * (B * S)
    want = torch.zeros((B, 2), dtype=torch.long)
    got = want.clone()
    got[0, 0] = 3                                  # row 0's first token
    flips, down, _, _ = _run(one, one, decode_rank=[[0.1, 0.2, 0.3, 0.4],
                                                    BASE],
                             got=got, want=want)
    assert flips[0][6] and down == [1, None]


def test_keep_masks_that_move_without_a_flip_fail():
    one = _layer([BASE] * (B * S))
    rank = _layer([BASE] * (B * S))
    rank["keep"] = rank["keep"].clone()
    rank["keep"][3] = False
    want = torch.zeros((B, 2), dtype=torch.long)
    with pytest.raises(AssertionError, match="keep masks differ"):
        cs.routing_flips([one, _layer([BASE] * B)],
                         [rank, _layer([BASE] * B)], want, want, K, "test")


def test_tokens_part_only_at_a_tie_or_downstream_of_a_flip():
    want = torch.tensor([[5, 6, 7], [5, 6, 7]])
    got = torch.tensor([[5, 6, 7], [5, 2, 7]])
    logits = torch.zeros((2, 3, 8))
    logits[:, :, 6] = 4.0                          # row 1 step 1: 6 leads 2
    logits[:, :, 2] = 3.0                          # by 1.0, 32 bf16 ulps
    with pytest.raises(AssertionError, match="not a tie"):
        cs.tie_divergences(got, want, logits, "test")
    assert cs.tie_divergences(got, want, logits, "test",
                              [None, 0]) == [(1, 1, 1.0, "routing")]
    with pytest.raises(AssertionError, match="not a tie"):
        cs.tie_divergences(got, want, logits, "test", [None, 2])
    logits[1, 1, 2] = 4.0 - 2 ** -6                # within one ulp of 4.0
    assert cs.tie_divergences(got, want, logits, "test") == [
        (1, 1, 2 ** -6)]


V = 8


def _serving(one, rank, got, want, logits_rank=None):
    """``tp_bf16_checks`` on hand-made prefill routing (``one``,
    ``rank``), one decode step routed alike, the one rank's logits
    favouring its own tokens by 4.0 at each step."""
    logits = torch.zeros((B, 2, V))
    logits.scatter_(2, want[..., None], 4.0)
    rf = {"routing": [_layer(one), _layer([BASE] * B)], "tokens": want,
          "logits": logits}
    sv = {"routing": [_layer(rank), _layer([BASE] * B)], "tokens": got,
          "logits": logits.clone() if logits_rank is None else logits_rank}
    cfg = SimpleNamespace(moe=SimpleNamespace(top_k=K))
    return cs.tp_bf16_checks("test", cfg, sv, rf), logits


def test_step_logits_are_held_on_the_rows_whose_tokens_agree():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    rank[0] = [0.4, 0.3001, 0.2, 0.0999]
    one[6] = [0.4, 0.2501, 0.25, 0.0999]          # row 1's prefill flips
    rank[6] = [0.4, 0.25, 0.2501, 0.0999]
    want = torch.zeros((B, 2), dtype=torch.long)
    text, logits = _serving(one, rank, want.clone(), want)
    assert "logits held on [2, 2] rows a step" in text
    # a decode step's logits past LOGITS_RTOL of 4.0 on a row whose
    # tokens agree fail, downstream of a flip or not
    for row in range(B):
        off = logits.clone()
        off[row, 1, 1] += 0.25
        with pytest.raises(AssertionError, match="step 1: logits"):
            _serving(one, rank, want.clone(), want, off)
    # once a row's tokens part (downstream of its flip), its later steps
    # are another history and are not held
    got = want.clone()
    got[1, 0] = 3
    off = logits.clone()
    off[1, 1] += 3.0
    text, _ = _serving(one, rank, got, want, off)
    assert "logits held on [2, 1] rows a step" in text


def test_a_step_that_holds_no_row_fails():
    one = [BASE] * (B * S)
    rank = [list(p) for p in one]
    rank[0] = [0.4, 0.3001, 0.2, 0.0999]
    for i in (3, 6):                              # a flip in each row
        one[i] = [0.4, 0.2501, 0.25, 0.0999]
        rank[i] = [0.4, 0.25, 0.2501, 0.0999]
    want = torch.zeros((B, 2), dtype=torch.long)
    got = want.clone()
    got[:, 0] = 3
    with pytest.raises(AssertionError, match="on its 0 rows"):
        _serving(one, rank, got, want)
