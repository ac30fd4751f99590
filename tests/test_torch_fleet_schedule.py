"""The pipeline's global 1F1B schedule
(``paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel
.schedule``), which every rank derives alone: each action once, in
dependency order, at most a warm-up's micro-batches in flight a chunk,
and the reference's 1F1B shape per chunk."""
import pytest

from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_parallel import \
    schedule


@pytest.mark.parametrize("chunks,micro", [(1, 1), (1, 4), (2, 4), (4, 2),
                                          (4, 8), (3, 5), (8, 4)])
def test_schedule_is_a_valid_1f1b(chunks, micro):
    order = schedule(chunks, micro)
    tick = {(kind, k, i): t for t, k, kind, i in order}
    assert len(order) == len(tick) == 2 * chunks * micro
    for k in range(chunks):
        for i in range(micro):
            if k:
                assert tick[("F", k, i)] > tick[("F", k - 1, i)]
            if k < chunks - 1:
                assert tick[("B", k, i)] > tick[("B", k + 1, i)]
            assert tick[("B", k, i)] > tick[("F", k, i)]
        # in order, and never more micro-batches held than 1F1B holds
        fs = [i for t, kk, kind, i in order if kk == k and kind == "F"]
        bs = [i for t, kk, kind, i in order if kk == k and kind == "B"]
        assert fs == bs == list(range(micro))
        held = peak = 0
        for t, kk, kind, i in order:
            if kk == k:
                held += 1 if kind == "F" else -1
                peak = max(peak, held)
        assert peak == min(chunks - k, micro)
    assert [t for t, *_ in order] == sorted(t for t, *_ in order)


def test_schedule_steady_state_alternates():
    """The first chunk of 4 over 8 micro-batches: 3 warm-up forwards,
    then one forward, one backward, ..., then the cool-down backwards."""
    kinds = "".join(kind for _, k, kind, _ in schedule(4, 8) if k == 0)
    assert kinds == "FFF" + "FB" * 5 + "BBB"


@pytest.mark.parametrize("chunks,micro", [(2, 3), (4, 4)])
def test_forward_only_schedule(chunks, micro):
    order = schedule(chunks, micro, train=False)
    assert {kind for _, _, kind, _ in order} == {"F"}
    assert len(order) == chunks * micro
    tick = {(k, i): t for t, k, _, i in order}
    for k in range(1, chunks):
        for i in range(micro):
            assert tick[(k, i)] > tick[(k - 1, i)]
