"""The yardstick's arithmetic against hand counts: a GF(2^8) product's
least time, olmo-1b's FLOPs a train step, the percentile and the gaps."""
import math

import pytest

from perfbench import gen, roofline
from perfbench.common import gap, p95, worst_leaf_gap
from perfbench.run import read_json, ROOT

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_gf_bound_is_operation_bound_for_a_checkpoint_encode():
    # (128, 64, 199,966,721): bytes (8,192 + 192 N) over 3.35 TB/s is
    # 11.46 ms; 128 int8 operations a field product, 128*128*64*N over
    # 1,979 TOP/s, is 105.95 ms
    m, k, n = 128, 64, 199_966_721
    assert roofline.gf_product_bound_s(m, k, n, H100) == pytest.approx(
        128 * 128 * 64 * n / 1979e12)
    assert roofline.gf_product_bound_s(m, k, n, H100) == pytest.approx(
        0.10595265509817887)


def test_gf_bound_is_byte_bound_for_a_single_row():
    # (1, 1, 4 MiB): 8 MiB + 1 byte over 3.35 TB/s against 128 * 4 MiB
    # operations over 1,979 TOP/s
    n = 4 << 20
    assert roofline.gf_product_bound_s(1, 1, n, H100) == pytest.approx(
        (1 + n + n) / 3.35e12)


def test_olmo_1b_train_step_flops():
    cfg = read_json(ROOT / "perfbench/configs/olmo-1b-ec8.json")
    model = cfg["model"]
    # 16 layers of 4 * 2048 * 16 * 128 + 3 * 2048 * 8192, and the head
    # 50,304 * 2048: 1,176,764,416 matmul parameters
    assert roofline.decoder_matmul_params(model) == 1_176_764_416
    # 8,192 tokens: 6 N T plus 6 L S d T of causal attention
    assert roofline.train_step_flops(model, 8192, 2048) == \
        6 * 1_176_764_416 * 8192 + 6 * 16 * 2048 * 2048 * 8192
    assert roofline.train_step_flops(model, 8192, 2048) == 61138859458560


def test_olmo_1b_ties_its_head_to_the_embedding():
    # the paper's 1.18B parameters: 16 layers of 4 * 2048 * 2048 +
    # 3 * 2048 * 8192, and one 50,304 x 2048 embedding that is also the head
    cfg = read_json(ROOT / "perfbench/configs/olmo-1b-ec8.json")
    leaves = gen.decoder_leaves(cfg["model"])
    assert "embed.unembed" not in [n for n, _, _ in leaves]
    assert sum(math.prod(s) for _, s, _ in leaves) == 1_176_764_416
    untied = gen.decoder_leaves(dict(cfg["model"], tie_embeddings=False))
    assert sum(math.prod(s) for _, s, _ in untied) == \
        1_176_764_416 + 50_304 * 2048


def test_p95_and_gaps():
    assert p95([float(i) for i in range(1, 101)]) == pytest.approx(95.95)
    assert p95([1.0]) is None
    assert gap(1.01, 1.0) == pytest.approx(0.01)
    # the median leaf's norm is the floor of the scale
    assert worst_leaf_gap([1.0, 2.0, 0.1], [1.0, 2.0, 0.0]) == \
        pytest.approx(0.1 / 1.0)
    assert worst_leaf_gap([1.0, 3.0], [1.0, 2.0], skip=[False, True]) == 0
