"""The MAF device tools' batcher alone (ops.pipeline.overlapped): batch
boundaries by the padded-columns rule, input order with items that go
alone, and one batch in flight (start of batch i+1 before finish of
batch i)."""

import numpy as np
import pytest

from wgatools_tpu_torch.ops.pipeline import overlapped


def _rule_batches(widths, budget):
    """The flush rule written out: a batch closes before the item that
    would take its widest width times its items past the budget."""
    batches, pending, widest = [], [], 0
    for k, n in enumerate(widths):
        wide = max(widest, n)
        if pending and wide * (len(pending) + 1) > budget:
            batches.append(pending)
            pending, wide = [], n
        widest = wide
        pending.append(k)
    if pending:
        batches.append(pending)
    return batches


def _run(widths, budget, alone=None):
    """(the batches start saw as item indices, the log of start/finish
    and alone calls, what finish and alone yielded)."""
    log, seen = [], []

    def start(batch):
        ks = [k for _, k in batch]
        seen.append(ks)
        log.append(("start", len(seen) - 1))
        return len(seen) - 1, ks

    def finish(state):
        i, ks = state
        log.append(("finish", i))
        yield from ks

    def answer(item):
        log.append(("alone", item[1]))
        yield item[1]

    items = [(range(n), k) for k, n in enumerate(widths)]
    out = list(overlapped(iter(items), start, finish, budget, None,
                          alone and (alone, answer)))
    return seen, log, out


@pytest.mark.parametrize("budget", [1000, 4096, 6000])
@pytest.mark.parametrize("seed", range(4))
def test_batches_follow_the_flush_rule(seed, budget):
    """Random widths, with widths of 0, exactly the budget and past it."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, budget // 3, 200).tolist()
    for k in rng.choice(200, 12, replace=False).tolist():
        widths[k] = [0, budget, budget + 1, budget // 2][k % 4]
    seen, _, out = _run(widths, budget)
    assert seen == _rule_batches(widths, budget)
    assert out == list(range(len(widths)))


@pytest.mark.parametrize("at", [(0,), (7,), (19,), (0, 1, 10, 19), (9, 10)],
                         ids=["first", "middle", "last", "spread", "twice"])
def test_alone_items_keep_order(at):
    """An item of `alone` columns or more is answered on its own after
    every batch before it has finished, and the next batch begins afresh;
    order holds."""
    rng = np.random.default_rng(3)
    widths = rng.integers(1, 500, 20).tolist()
    for k in at:
        widths[k] = 3000
    seen, log, out = _run(widths, 1200, alone=3000)
    assert out == list(range(20))
    for k in at:
        # every batch of items before it has finished before its answer
        before = [i for i, b in enumerate(seen) if b[0] < k]
        assert all(log.index(("finish", i)) < log.index(("alone", k))
                   for i in before)
    # between alone items, batches by the rule, begun afresh after each
    want, lo = [], 0
    for hi in [*at, 20]:
        want += [[lo + k for k in b]
                 for b in _rule_batches(widths[lo:hi], 1200)]
        lo = hi + 1
    assert seen == want


@pytest.mark.parametrize("budget", [600, 2000])
def test_next_batch_starts_before_finish(budget):
    """start of batch i+1 runs before finish of batch i, and at most one
    batch is in flight."""
    widths = np.random.default_rng(5).integers(1, 300, 60).tolist()
    seen, log, _ = _run(widths, budget)
    assert len(seen) > 3
    for i in range(len(seen) - 1):
        assert log.index(("start", i + 1)) < log.index(("finish", i))
    for i in range(2, len(seen)):
        assert log.index(("finish", i - 2)) < log.index(("start", i))
