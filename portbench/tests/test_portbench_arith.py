"""The yardstick's arithmetic against hand-worked numbers: the codec's byte
bound, a decoder's FLOPs and MFU, the card's peaks, and the trace's busy
and idle time."""

import pathlib
import sys

import pytest

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import arith, bench, trace  # noqa: E402

QWEN2 = dict(d_model=1536, n_layers=28, n_heads=12, n_kv_heads=2,
             d_head=128, d_ff=8960, vocab=151936)


def test_codec_bound_is_phase_2s():
    # (65536, 256) fp32: 16 bytes an element at 3.35 TB/s is 0.0801 ms
    bw = arith.card_peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"]
    assert arith.ef_int8_bound_s(65536 * 256, bw) * 1e3 == \
        pytest.approx(0.0801, abs=5e-5)


def test_peaks_by_card_name():
    assert arith.card_peaks("NVIDIA H100 80GB HBM3") == {
        "bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12}
    assert arith.card_peaks("NVIDIA H100 PCIe")["bf16_flops"] == 756e12
    with pytest.raises(KeyError):
        arith.card_peaks("cpu")


def test_qwen2_matmul_parameters_by_hand():
    # per layer: q, k, v and o 1536 x (12 + 2 + 2) x 128 + 12 x 128 x 1536,
    # the MLP 3 x 1536 x 8960; the tied head 151936 x 1536 once
    per_layer = 1536 * 16 * 128 + 12 * 128 * 1536 + 3 * 1536 * 8960
    assert per_layer == 46_792_704
    assert arith.decoder_matmul_params(**QWEN2) == \
        28 * per_layer + 151936 * 1536 == 1_543_569_408


def test_mfu_of_phase_12a():
    """6N alone gives 0.082 at 466.8 ms a step of 8 x 512 tokens."""
    n = arith.decoder_matmul_params(**QWEN2)
    mfu = 6 * n * 8 * 512 / 0.4668 / 989e12
    assert mfu == pytest.approx(0.082, abs=5e-4)
    # causal attention adds 12 x 28 x 12 x 128 x 256.5 a token: ~1.4%
    per_token = arith.decoder_train_flops_per_token(**QWEN2, seq_len=512)
    assert per_token - 6 * n == pytest.approx(12 * 28 * 12 * 128 * 256.5)
    assert (per_token - 6 * n) / (6 * n) == pytest.approx(0.0143, abs=5e-4)


def _trace():
    # window [0, 100); ops [10, 20), [15, 30) overlap; [50, 60) a copy
    return trace.Trace((0, 100), [
        (10, 20, "(anonymous namespace)::a_kernel(int)", "kernel"),
        (15, 30, "b_kernel", "kernel"),
        (50, 60, "Memcpy HtoD (Pageable -> Device)", "memcpy")])


def test_busy_is_the_union_and_idle_gaps_are_its_complement():
    t = _trace()
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(30e-9)
    assert t.idle_gaps() == [(0, 10), (30, 50), (60, 100)]
    assert t.seconds(lambda n, k: k == "kernel") == pytest.approx(25e-9)


def test_breakdown_names_what_the_card_waited_for():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["b_kernel", pytest.approx(15e-9)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"before the window's end": pytest.approx(40e-9),
                    "before Memcpy HtoD (Pageable -> Device)":
                        pytest.approx(20e-9),
                    "before a_kernel": pytest.approx(10e-9)}


def test_device_metrics_read_nothing_off_the_card():
    cell = bench.Cell("x", 1, {}, {}, [], [])
    run = bench.Run(cell, 1, "cpu", 0.0)
    run.trace = _trace()
    run.work.update(batches=1, codec_elements=10)
    for name in ("device_idle_share.stream", "ef_int8_roofline.stream"):
        assert cell.reader(name).read(run) is None


def test_idle_share_is_the_window_less_the_union():
    cell = bench.Cell("x", 1, {}, {}, [], [])
    run = bench.Run(cell, 1, "cuda", 0.0)
    assert cell.reader("device_idle_share.stream").read(run) is None
    run.trace = _trace()
    assert cell.reader("device_idle_share.stream").read(run) == \
        pytest.approx(70.0)


def test_host_counters_move_forward_over_work():
    start = bench.host_counters()
    sum(i * i for i in range(200_000))
    moved = bench.counters_since(start)
    assert set(moved) == {"cpu_s", "minflt", "majflt", "nvcsw", "nivcsw"}
    assert moved["cpu_s"] >= 0 and all(v >= 0 for v in moved.values())
