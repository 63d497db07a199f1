"""The yardstick's counts against hand counts at small shapes."""
import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import roofline as R

METRICS = Path(R.__file__).resolve().parent / "metrics"


def _module(name):
    spec = importlib.util.spec_from_file_location(
        f"test_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ATTN = _module("attn_roofline.serve")
TRAIN = _module("kernel_roofline.train")


@pytest.mark.parametrize("s,w,pairs", [(1, 0, 1), (4, 0, 10), (5, 2, 9),
                                       (3, 8, 6), (6, 3, 15)])
def test_causal_pairs_by_hand(s, w, pairs):
    # (6, 3): rows see 1, 2, 3, 3, 3, 3 keys
    assert R.causal_pairs(s, w) == pairs


def test_bound_takes_the_larger_time():
    assert R.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 989e12) == pytest.approx(1.0)
    assert R.bound_s(3.35e9, 989e12) == pytest.approx(1.0)
    assert R.bound_s(0, 67e12, R.PEAK_F32_FLOPS) == pytest.approx(1.0)


def test_decode_counts_ragged_lanes_and_empty_slots():
    # lane 0 holds positions 0..4 and reads 5 keys; lane 1 holds 0..1 (two
    # empty slots); lane 2 has a window of... none: its cache_len is 1
    pos = torch.tensor([[0, 1, 2, 3, 4, -1], [0, 1, -1, -1, -1, -1],
                        [0, 7, 8, -1, -1, -1]], dtype=torch.int32)
    rec = dict(op="decode_attention", q=(3, 1, 4, 8), hkv=2, window=0,
               cache_len=torch.tensor([5, 2, 1]), pos=pos, n=6)
    assert ATTN._visible_decode(rec) == 5 + 2 + 1
    rec["window"] = 3            # lane 0 sees positions 2..4
    assert ATTN._visible_decode(rec) == 3 + 2 + 1
    b = ATTN.bound_s(dict(rec, window=0))
    work = R.attention_work(8, 3, 8, 4, 2, 8)
    assert work == {"flops": 4.0 * 8 * 4 * 8,
                    "bytes": 2.0 * 8 * (2 * 4 * 3 + 2 * 2 * 8)}
    assert b == pytest.approx(R.bound_s(work["bytes"], work["flops"]))


def test_paged_counts_only_mapped_positions():
    tables = torch.tensor([[3, 1, -1], [-1, -1, -1], [0, -1, -1]],
                          dtype=torch.int32)
    rec = dict(op="paged_decode_attention", q=(3, 1, 4, 8), hkv=2,
               window=0, cache_len=torch.tensor([6, 3, 9]), tables=tables,
               page=4)
    # lane 0: 6 positions over two mapped pages; lane 1: none mapped;
    # lane 2: its one page holds 4 of its 9 positions
    assert ATTN._visible_decode(rec) == 6 + 0 + 4


def test_flash_chunk_counts_ring_and_chunk_pairs():
    # a chunk at positions 4..6 over a ring holding 0..3 and one empty slot
    rec = dict(op="flash_attention", q=(1, 3, 4, 8), k=(1, 3, 2, 8), hkv=2,
               window=0, causal=True,
               q_pos=torch.tensor([4, 5, 6]), k_pos=torch.tensor([4, 5, 6]),
               cache_pos=torch.tensor([[0, 1, 2, 3, -1]]))
    pairs, rows = ATTN._visible_flash(rec)
    assert pairs == (1 + 2 + 3) + 3 * 4
    assert rows == 3 + 4
    rec["window"] = 2            # query 4 sees 3, 4; 5 sees 4, 5; 6: 5, 6
    pairs, rows = ATTN._visible_flash(rec)
    assert pairs == 6 and rows == 3 + 1


def test_token_and_span_flops_agree():
    c = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, sliding_window=0)
    span = R.span_flops(c, 3, 9, 0)
    assert span == pytest.approx(sum(R.token_flops(c, p, False)
                                     for p in range(3, 9)))
    p = R.dense_params(c)
    assert p == {"attn": 64 * 16 * 12, "mlp": 3 * 64 * 128,
                 "head": 64 * 256}
    # one token at position 0: 2 per weight, 4 d a head over one key
    assert R.token_flops(c, 0, True) == 2 * (
        2 * (p["attn"] + p["mlp"]) + 4 * 16 * 4) + 2 * p["head"]
    moe = dict(c, num_experts=8, num_experts_per_tok=2)
    assert R.dense_params(moe)["mlp"] == 2 * 3 * 64 * 128 + 64 * 8
    w = dict(c, sliding_window=4)
    assert R.span_flops(w, 0, 10, 0) == pytest.approx(
        sum(R.token_flops(w, q, False) for q in range(10)))


def test_train_flops_by_hand():
    c = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, sliding_window=0)
    mats = 2 * (64 * 16 * 12 + 3 * 64 * 128)
    assert R.train_flops(c, 2, 32) == 2 * 32 * (
        6 * (mats + 64 * 256) + 2 * 4 * 6 * 32 * 16)


def test_train_kernel_bounds():
    rec = dict(op="flash_attention", q=(2, 8, 4, 16), hkv=2, window=0)
    fwd, bwd = TRAIN._flash(rec), TRAIN._flash(rec, bwd=True)
    pairs = 2 * 36
    assert fwd == pytest.approx(R.bound_s(2 * 16 * (2 * 4 * 16 + 2 * 2 * 16),
                                          4 * 16 * 4 * pairs))
    assert bwd == pytest.approx(R.bound_s(2 * 16 * (4 * 4 * 16 + 4 * 2 * 16),
                                          10 * 16 * 4 * pairs))
    norm = dict(op="add_rmsnorm", rows=10, width=64, elt=2)
    assert TRAIN._norm(norm) == pytest.approx(2 * 10 * 64 * 4 / 3.35e12)
