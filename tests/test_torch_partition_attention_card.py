"""``partition_attention`` on the card at the engine's decode shape: 64
rows of full-width qwen2-7b heads (Hkv 4, G 7, Dh 128, bf16) over 2,048-slot
rows, at positions drawn as the benchmark's saturated mix binds them
(``launch/attention_cases.py::engine_positions``), with the split-K
design's edge rows planted among them (``edge_positions``: lengths under
one tile, of exactly one, not a multiple of the split, the ring's end,
rings wrapped far past T, and pos = -1, every slot masked: the mean of V).

Every split count the kernel takes (1 to ``MAX_SPLITS``) is passed to the
extension directly and held to the plain version (``ref``) within
``attention_close``'s limits; the count ``splits_for`` picks goes through
``ops``.  This file imports no JAX, so it runs on the chip with
``PYTHONPATH=src python -m pytest -q --noconftest -m card
tests/test_torch_partition_attention_card.py``; elsewhere it skips.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import partition_attention as pa
from repro_torch.launch.attention_cases import (ENGINE_ROWS,
                                                attention_close,
                                                edge_positions,
                                                engine_positions, mean_of_v)

T, HKV, G, DH = 2048, 4, 7, 128
EDGES = edge_positions(T)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _inputs(dev):
    """q, K, V drawn on the card from a fixed seed; the engine's positions
    with the edge rows in place of the first function's eight."""
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((ENGINE_ROWS, HKV, G, DH), (ENGINE_ROWS, T, HKV, DH),
                         (ENGINE_ROWS, T, HKV, DH)))
    pos = torch.from_numpy(engine_positions(32))
    pos[:len(EDGES)] = torch.tensor(EDGES, dtype=torch.int32)
    return q, k, v, pos.to(dev)


def _assert_close(got, want):
    ok, err, limit = attention_close(got, want)
    assert ok, (err, limit)


@pytest.mark.card
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("splits", range(1, pa.MAX_SPLITS + 1))
def test_every_split_count_is_the_plain_version(card, splits, window):
    q, k, v, pos = _inputs(card)
    ext = ops.load()
    out = torch.empty_like(q)
    none = torch.empty(0, dtype=torch.float32, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    ext.partition_attention(q, k, v, pos, out, none, none, splits,
                            DH ** -0.5, 0.0, window, 0, T, stream)
    want = ref.partition_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    _assert_close(out, want)
    masked = EDGES.index(-1)
    _assert_close(out[masked], mean_of_v(v[masked], G))


@pytest.mark.card
def test_the_picked_count_through_ops(card):
    """The wrapper launches ``splits_for``' count for the engine's shape
    once (4 on an H100, where the card holds 5 blocks an SM) and gives the
    plain version's output."""
    q, k, v, pos = _inputs(card)
    ext = ops.load()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    per_sm = pa.blocks_per_sm(ext, card.index, DH, True)
    assert pa.splits_for(ext, q, T) \
        == pa.num_splits(ENGINE_ROWS, HKV, G, T, sms, per_sm)
    if torch.cuda.get_device_name(card) == "NVIDIA H100 80GB HBM3":
        assert (sms, per_sm, pa.splits_for(ext, q, T)) == (132, 5, 4)
    n = ops.LAUNCHES["partition_attention"]
    got = ops.partition_attention(q, k, v, pos)
    want = ref.partition_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["partition_attention"] == n + 1
    _assert_close(got, want)
