"""The benchmark's frozen FLOP count against XLA's cost analysis."""

from benchmark.yardstick import flops

XLA_GATED_V4_GFLOP = 28.18  # bench.py: XLA's cost analysis of the gated_v4 forward
GATED_V4 = {"image_size": 299,
            "model": {"registry": "gated_v4", "embedding_dim": 32, "hidden_dim": 64,
                      "num_layers": 1, "output_len": 12, "image_arch": "resnet101"}}


def test_forward_count_matches_xla_within_one_percent():
    # The count leaves out element-wise work (BatchNorm, ReLU, the pool,
    # softmax), which XLA counts: the count sits just under XLA's.
    ours = flops.forward_flops_per_row(GATED_V4) / 1e9
    assert 0.99 * XLA_GATED_V4_GFLOP <= ours <= XLA_GATED_V4_GFLOP, ours


def test_padding_taps_are_not_counted():
    # A 3x3 convolution at stride 1 on a 10 x 10 input: 28 of 30 taps a dim.
    assert flops.valid_taps(10, 3, 1) == 28
    assert flops.conv_flops(10, 1, 1, 3, 1) == 2 * 28 * 28


def test_train_count_follows_the_freeze_split():
    fwd, train = flops.backbone_forward_flops(), flops.backbone_train_flops()
    table = flops.backbone_table("resnet101", 299)
    frozen = sum(flops.conv_flops(h, ci, co, k, s) * n
                 for name, h, ci, co, k, s, n in table["convs"]
                 if name.startswith(tuple(table["frozen_stages"])))
    first = sum(flops.conv_flops(h, ci, co, k, s) * n
                for name, h, ci, co, k, s, n in table["convs"]
                if name in table["first_trainable"])
    assert train == fwd + 2 * (fwd - frozen) - first


def test_work_is_found_by_the_configurations_names():
    # A backbone without a table, a family without a file: a KeyError that
    # names the file to add, not a wrong count.
    import pytest

    with pytest.raises(KeyError, match="resnet50_224"):
        flops.backbone_table("resnet50", 224)
    with pytest.raises(KeyError, match="no_such_family"):
        flops.heads_flops({"registry": "no_such_family"})
