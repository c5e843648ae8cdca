"""FLOP and byte counts against hand counts at small shapes."""

import pytest

from codec_bench import roofline


def test_layer_macs_by_hand():
    macs = roofline.layer_macs(32, 16, learn_bin_widths=True)
    assert macs["conv_1"] == 8 * 4 * 81 * 128
    assert macs["gdn_1"] == 8 * 4 * 128 * 128
    assert macs["conv_2"] == 4 * 2 * 25 * 128 * 128
    assert macs["conv_3"] == 2 * 1 * 25 * 128 * 128
    assert macs["tconv_4"] == 2 * 1 * 25 * 128 * 128
    assert macs["tconv_6"] == 8 * 4 * 81 * 128
    assert "gdn_3" not in macs and "igdn_4" not in macs
    fixed = roofline.layer_macs(32, 16, learn_bin_widths=False)
    assert fixed["gdn_3"] == fixed["igdn_4"] == 2 * 128 * 128


def test_conv_eae_flops_equals_the_ports():
    from autoencoder_based_image_compression_tpu_torch.eval.roofline import conv_eae_flops

    for learn in (True, False):
        for (height, width) in ((16, 16), (512, 768), (256, 256)):
            assert roofline.conv_eae_flops(height, width, learn) == conv_eae_flops(
                height, width, learn)


def test_train_flops_by_hand():
    macs = roofline.layer_macs(16, 16, learn_bin_widths=True)
    encoder = macs["conv_1"] + macs["gdn_1"] + macs["conv_2"] + macs["gdn_2"] + macs["conv_3"]
    expected = encoder + 2 * macs["conv_1"] + 3 * (sum(macs.values()) - macs["conv_1"])
    assert roofline.train_flops(16, 16, True) == 2 * expected


def test_serve_flops_split_by_dtype():
    flops = roofline.serve_flops(16, 32, True, ("tconv_5", "igdn_6"))
    macs = roofline.layer_macs(16, 32, True)
    assert flops["bf16"] == 2 * (macs["tconv_5"] + macs["igdn_6"])
    assert flops["fp32"] + flops["bf16"] == roofline.conv_eae_flops(16, 32, True)
    assert roofline.least_time_s({"fp32": 67e12, "bf16": 989e12}) == pytest.approx(2.0)


def test_gdn_bound_by_hand():
    (seconds, by) = roofline.gdn_bound_s(1000, "fp32")
    assert by == "operations"
    assert seconds == pytest.approx(2 * 1000 * 128 * 128 / 67e12)
    (seconds, by) = roofline.gdn_bound_s(1000, "bf16")
    assert by == "bytes"
    assert seconds == pytest.approx((2 * 1000 * 128 * 2 + (128 * 128 + 128) * 4) / 3.35e12)
    (stacked, _) = roofline.gdn_bound_s(1000, "fp32", models=7)
    assert stacked == pytest.approx(7 * roofline.gdn_bound_s(1000, "fp32")[0])


def test_gdn_sites_of_the_paths():
    serve = roofline.serve_gdn_sites(True, 4, 512, 768, ("igdn_6",))
    assert serve == [(98304, "fp32", 1), (24576, "fp32", 1), (24576, "fp32", 1),
                     (98304, "bf16", 1)]
    train = roofline.train_gdn_sites(False, 10, 256, 256, models=7)
    assert [rows for (rows, _, _) in train] == [40960, 10240, 2560, 40960, 10240, 2560, 2560,
                                               10240, 40960]
    assert all(models == 7 for (_, _, models) in train)
