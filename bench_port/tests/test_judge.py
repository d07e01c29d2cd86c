"""The judge of pair traffic takes every distinct answer of the window,
up to ``MAX_ANSWERS_PER_PAIR`` a pair on average: then each pair's most
frequent answer and a sample of the rest drawn from the seed."""

import torch

from bench_port.judges import pairs as judge


def test_few_distinct_answers_are_all_judged():
    which = torch.tensor([0, 0, 1, 2])
    assert judge.capped(which, torch.tensor([5, 1, 6, 6]), 3, 7).tolist() \
        == [0, 1, 2, 3]


def test_many_distinct_answers_keep_each_pairs_most_frequent():
    n_pairs, per_pair = 3, 10
    which = torch.arange(n_pairs).repeat_interleave(per_pair)
    n_calls = torch.ones(n_pairs * per_pair, dtype=torch.long)
    top = torch.tensor([4, 13, 29])
    n_calls[top] = 5
    keep = judge.capped(which, n_calls, n_pairs, 2**35 + 1)
    assert len(keep) == judge.MAX_ANSWERS_PER_PAIR * n_pairs
    assert set(top.tolist()) <= set(keep.tolist())
    assert keep.tolist() == sorted(set(keep.tolist()))
    again = judge.capped(which, n_calls, n_pairs, 2**35 + 1)
    other = judge.capped(which, n_calls, n_pairs, 2**35 + 2)
    assert torch.equal(keep, again) and not torch.equal(keep, other)


def test_unique_answers_count_the_calls_that_gave_each():
    rot = torch.eye(2).expand(3, 2, 2, 2).clone()
    t = torch.zeros(3, 2, 2)
    t[1, 1, 0] = 1.0
    which, r, tt, n = judge.unique_answers(rot, t)
    assert which.tolist() == [0, 1, 1] and n.tolist() == [3, 2, 1]
    assert tt[2, 0] == 1.0
