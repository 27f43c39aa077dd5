"""The traffic generator: deterministic for a seed, the same work in
another order for another seed, and the classes' medians and clipping."""
import numpy as np
import pytest

from portbench import spec as S
from portbench import traffic as T


def _mix(name):
    return S.Spec().traffic(name)


def test_same_seed_same_inputs():
    mix = _mix("mixed.opt13b")
    a = T.schedule(mix, 20.0, 2 ** 31 + 17, 50272)
    b = T.schedule(mix, 20.0, 2 ** 31 + 17, 50272)
    assert [(x.due, x.prompt_len, x.n_out) for x in a] == \
        [(x.due, x.prompt_len, x.n_out) for x in b]
    assert all((x.tokens == y.tokens).all() for x, y in zip(a, b))


def test_other_seed_same_work_other_tokens():
    mix = _mix("mixed.opt13b")
    a = T.schedule(mix, 30.0, 11, 50272)
    b = T.schedule(mix, 30.0, 12, 50272)
    assert [(x.due, x.prompt_len, x.n_out) for x in a] == \
        [(x.due, x.prompt_len, x.n_out) for x in b]
    assert all(x.due < 30.0 for x in a)
    assert any((x.tokens != y.tokens).any() for x, y in zip(a, b))
    assert len(a) == round(30.0 * mix["arrivals"]["rate"])


def test_class_medians_and_clipping():
    mix = _mix("mixed.opt13b")
    rng = np.random.default_rng(0)
    prompt, out = T.lengths(mix, 40000, rng)
    assert prompt.min() >= 1 and prompt.max() <= 1792
    assert out.min() >= 1 and (prompt + out).max() <= 2040
    short = prompt[prompt < 200]
    long = prompt[prompt >= 200]
    assert abs(np.median(short) - 18) <= 2
    assert abs(np.median(long) - 1100) / 1100 < 0.05
    assert abs(len(long) / len(prompt) - 0.35) < 0.02
    heavy = out[prompt + out < 2040]
    assert abs(np.median(heavy[heavy >= 150]) - 420) / 420 < 0.05


def test_rate_and_unknown_process():
    mix = _mix("mixed.opt13b")
    items = T.schedule(mix, 200.0, 5, 100, rate=3.0)
    assert len(items) == 600
    with pytest.raises(ValueError):
        T.schedule(dict(mix, arrivals={"process": "bursty", "rate": 1.0}),
                   10.0, 5, 100)


def test_every_mix_file_draws():
    for path in sorted((S.HERE / "traffic").glob("*.json")):
        mix = S.load_json(path)
        items = T.schedule(mix, 51.0, 7, 1000)
        assert items and all(0 <= x.due < 51.0 for x in items)
        assert all(x.prompt_len + x.n_out <= mix["context_max"]
                   for x in items)


def test_warmup_is_fixed():
    mix = _mix("mixed.opt13b")
    a, b = T.warmup(mix, 1000), T.warmup(mix, 1000)
    assert [x.prompt_len for x in a] == [x.prompt_len for x in b]
    assert all(x.n_out == mix["warmup"][1] for x in a)


def test_negative_and_huge_seeds():
    mix = _mix("mixed.opt13b")
    for s in (-3, 0, 2 ** 31 + 5, 2 ** 40):
        assert T.schedule(mix, 5.0, s, 100)
