"""One seed draws the same traffic twice, another seed other tokens, and
every seed the same sizes in the same order."""
import itertools

import pytest

from pulbench import spec, traffic as T

MIXES = ["longctx_decode", "chat_closed"]
SEEDS = (2**31 + 11, 2**31 + 12)


def _draws(mix, seed, n=300):
    t = T.Traffic(mix, seed, vocab=1000)
    if mix["mode"] == "closed_batch":
        return t.sessions()
    return list(itertools.islice(t.stream(), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = spec.traffic(name)
    T.check(mix)
    a, b = _draws(mix, SEEDS[0]), _draws(mix, SEEDS[0])
    assert [(d.prompt, d.max_new_tokens) for d in a] == [
        (d.prompt, d.max_new_tokens) for d in b]


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_tokens_same_sizes(name):
    mix = spec.traffic(name)
    a, b = _draws(mix, SEEDS[0]), _draws(mix, SEEDS[1])
    assert [d.prompt for d in a] != [d.prompt for d in b]
    assert [(len(d.prompt), d.max_new_tokens) for d in a] == [
        (len(d.prompt), d.max_new_tokens) for d in b]
    if mix["mode"] == "closed_loop":     # a pass over the pool: its sizes
        n = mix["pool"]
        a = _draws(mix, SEEDS[0], n)
        assert sorted(len(d.prompt) for d in a) == sorted(
            T.quantile_sizes(mix["prompt"], n).tolist())


def test_closed_loop_blocks_are_balanced():
    mix = spec.traffic("chat_closed")
    draws = _draws(mix, SEEDS[0], mix["strata"])
    lens = sorted(len(d.prompt) for d in draws)
    edges = T.quantile_sizes(mix["prompt"], mix["pool"]).reshape(
        mix["strata"], -1)
    assert all(row[0] <= n <= row[-1] for row, n in zip(edges, lens))


def test_quantile_sizes():
    s = T.quantile_sizes({"dist": "loguniform", "lo": 100, "hi": 400}, 2)
    assert s.tolist() == [141, 283]
    s = T.quantile_sizes({"dist": "lognormal", "median": 1000, "sigma": 1.0,
                          "lo": 10, "hi": 10000}, 3)
    assert s[1] == 1000 and s[0] < 1000 < s[2]


def test_pool_holds_the_sessions():
    """longctx's hot pages hold every session's prompt and every token it
    asks for; one page fewer than the sessions can fill is refused, and so
    is a session that cannot fit max_seq."""
    mix = spec.traffic("longctx_decode")
    need = T.session_pages(mix)
    assert need <= mix["engine"]["hot_pages"] < need + 64
    small = dict(mix, engine=dict(mix["engine"], hot_pages=need - 1))
    with pytest.raises(ValueError, match="hot_pages"):
        T.check(small)
    short = dict(mix, engine=dict(mix["engine"], max_seq=12288 + 1024))
    with pytest.raises(ValueError, match="max_seq"):
        T.check(short)
