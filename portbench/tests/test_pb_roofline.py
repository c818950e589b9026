"""The frozen roofline arithmetic reproduces the bounds PERF.md's kernel
table quotes, and the whole-step counts agree with the models' sizes."""
import dataclasses

import pytest

from portbench import roofline as rf
from portbench.harness import Bench, model_config
from portbench.tests._tiny import REPO


def cfg(name):
    return model_config(Bench(REPO).config(name))


@pytest.mark.parametrize("shape, want, by", [
    ((8, 32, 512, 512, 80, 2, 32), 0.025, "bytes"),
    ((1, 32, 4096, 4096, 80, 2, 32), 0.087, "operations"),
    ((8, 48, 512, 512, 128, 2, 8), 0.035, "bytes"),
])
def test_flash_bounds_match_the_kernel_table(shape, want, by):
    ms, got_by = rf.flash_bound_ms(*shape)
    assert round(ms, 3) == want and got_by == by


def test_ssd_bound_matches_the_kernel_table():
    ms, by = rf.ssd_bound_ms(8, 512, 80, 64, 64)
    assert round(ms, 3) == 0.026 and by == "bytes"


def test_ssd_bound_reads_b_and_c_per_group():
    one = rf.ssd_bound_ms(8, 512, 80, 64, 64)
    assert rf.ssd_bound_ms(8, 512, 80, 64, 64, groups=1) == one
    ms, by = rf.ssd_bound_ms(8, 512, 80, 64, 64, groups=2)
    # a second group's B and C: 2 x (8 x 512 x 64) bf16 elements more
    extra = 2 * 8 * 512 * 64 * rf.BF16 / rf.HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and ms == pytest.approx(one[0] + extra, rel=1e-12)
    assert rf.ssd_ops(8, 512, 80, 64, 64, groups=2) \
        == rf.ssd_ops(8, 512, 80, 64, 64)
    with pytest.raises(ValueError, match="do not split"):
        rf.ssd_ops(8, 512, 80, 64, 64, groups=3)


def test_causal_pairs_with_a_window():
    assert rf.causal_pairs(4, 4) == 10
    assert rf.causal_pairs(4, 4, window=2) == 7
    assert rf.causal_pairs(2, 4) == 3 + 4
    assert rf.flash_ops(1, 1, 4096, 4096, 80, 4096) \
        == rf.flash_ops(1, 1, 4096, 4096, 80)


def test_mixtral_stage_reads_its_weights_once_a_step():
    c = cfg("mixtral-8x22b-8l")
    # ~40.9 GB with the embedding table, which a step reads 64 rows of
    table = c.vocab_size * c.d_model * 2
    assert 40.8e9 < rf.weight_bytes(c) + table < 41.0e9
    ms, by = rf.decode_step_bound_ms(c, 64, 383)
    assert by == "bytes" and 12.0 < ms < 12.5


def test_prefill_flops_count_two_experts_and_the_head_once_a_prompt():
    c = cfg("mixtral-8x22b-8l")
    per_token = rf.prefill_flops(c, 1, 1) - 2 * c.d_model * c.vocab_size
    active = c.n_layers * (c.d_model * 64 * 128 + 48 * 128 * c.d_model
                           + c.d_model * 8 + 2 * 3 * c.d_model * c.d_ff)
    assert per_token == 2 * active + c.n_layers * 4 * 128 * 48
    dense = dataclasses.replace(c, family="dense", n_experts=0, d_ff=1024)
    assert rf.layer_macs_per_token(dense) == \
        rf.attn_weights(dense) + 3 * dense.d_model * 1024
    with pytest.raises(ValueError, match="no step arithmetic"):
        rf.prefill_flops(dataclasses.replace(c, family="hybrid"), 1, 8)
