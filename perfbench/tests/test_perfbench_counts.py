"""The counts against the figures worked by hand in counts.py."""

from pathlib import Path

from perfbench import counts, sizes

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def dims(name):
    return sizes.dims(sizes.load(CONFIGS / f"{name}.json"))


def test_mixtral_counts():
    d = dims("mixtral-8x22b-8L")
    assert counts.active_layer_params(d) == 692_109_312
    assert counts.active_layer_params(d) * d.n_layers == 5_536_874_496
    assert counts.unmasked_pairs(1024, 1024, True, 4096) == 524_800
    assert counts.prefill_flops(d, 1024) == 11_443_101_499_392
    assert counts.decode_flops(d, [1152] * 32) == 374_492_626_944
    assert abs(counts.experts_bound(d, 32) - 4_831_838_208 / 3.35e12) < 1e-12


def test_grok_counts():
    d = dims("grok-1-314b-4L")
    assert counts.active_layer_params(d) == 1_296_089_088
    assert counts.unmasked_pairs(6144, 6144, True, None) == 18_877_440
    assert counts.prefill_flops(d, 6144) == 65_562_709_327_872
    assert counts.decode_flops(d, [6160] * 4) == 50_339_512_320
    assert abs(counts.experts_bound(d, 4) - 9_663_676_416 / 3.35e12) < 1e-12


def test_window_caps_pairs_and_keys():
    d = dims("mixtral-8x22b-8L")
    assert counts.unmasked_pairs(5000, 5000, True, 4096) < 5000 * 5001 // 2
    assert counts.decode_flops(d, [5000]) == counts.decode_flops(d, [4096])


def test_flash_bound_takes_the_larger_term():
    b, hq, hkv, dh = 1, 48, 8, 128
    small = counts.flash_bound(b, hq, hkv, dh, 1, 1, True, None)
    assert small == 2 * dh * (2 * hq + 2 * hkv) / counts.HBM_BYTES_PER_S
    big = counts.flash_bound(b, hq, hkv, dh, 4096, 4096, True, None)
    assert big == counts.flash_flops(b, hq, dh, 4096, 4096, True, None) \
        / counts.PEAK_FLOPS
