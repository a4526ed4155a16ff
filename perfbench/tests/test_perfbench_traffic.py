"""The traffic generator: the same seed gives the same requests, every
seed sends the same sizes at the same steps, a stationary start sends
the requests in flight at step 0, and the rehearsal's rate is written
into every mix."""
import collections

import pytest

from pbench import cells, traffic

MIXES = sorted(p.stem for p in (cells.BENCH / "traffic").glob("*.json"))


def _documents_mix():
    """A documents mix of the generator's own (no cell runs one yet)."""
    mix = cells.mix("prefill")
    return {**mix, "name": "documents",
            "documents": {"count": 4, "tokens": 6144, "first": True},
            "prompt_tokens": {"dist": "uniform", "min": 32, "max": 128},
            "serving": {**mix["serving"], "s_max": 6656}}


def _in_flight(mix):
    return (len(traffic.in_flight(mix, traffic.master_block(mix))["prompt"])
            if mix.get("start") == "stationary" else 0)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = cells.mix(name)
    a = traffic.generate(mix, 2 ** 31 + 7, 400)
    b = traffic.generate(mix, 2 ** 31 + 7, 400)
    assert a == b and a
    c = traffic.generate(mix, 5, 400)
    assert [x.prompt for x in a] != [x.prompt for x in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_offers_the_same_block(name):
    mix = cells.mix(name)
    n = mix["block"]
    rate = mix["rehearsal"]["rate_per_step"]
    horizon = 10 * int(n / rate)

    docs = mix.get("documents") or {}
    skip = (docs["count"] if docs.get("first") else 0) + _in_flight(mix)

    def sizes(seed):
        items = traffic.generate(mix, seed, horizon)[skip:skip + n]
        return collections.Counter((x.prompt_tokens, x.max_new_tokens, x.doc)
                                   for x in items)

    assert sizes(1) == sizes(2 ** 33 + 1)


@pytest.mark.parametrize("name", MIXES + ["documents"])
def test_every_seed_sends_the_same_schedule(name):
    """Only the text follows the seed: the sizes, their order and the
    arrival steps are the mix's own, so a tail over the window reads the
    same load on every seed."""
    mix = _documents_mix() if name == "documents" else cells.mix(name)

    def schedule(seed):
        return [(x.prompt_tokens, x.max_new_tokens, x.arrive_step, x.doc)
                for x in traffic.generate(mix, seed, 400)]

    a, b = schedule(2 ** 31 + 7), schedule(2 ** 33 + 1)
    assert a == b and len(a) > mix["block"]
    # and each block of the mix still comes in another order
    n = mix["block"]
    docs = mix.get("documents") or {}
    skip = (docs["count"] if docs.get("first") else 0) + _in_flight(mix)
    blocks = [a[skip + i * n: skip + (i + 1) * n] for i in range(2)]
    assert [x[:2] for x in blocks[0]] != [x[:2] for x in blocks[1]]


@pytest.mark.parametrize("name", MIXES + ["documents"])
def test_lengths_within_the_mix(name):
    mix = _documents_mix() if name == "documents" else cells.mix(name)
    s = mix["serving"]
    docs = mix.get("documents")
    items = traffic.generate(mix, 11, 300)
    flight = _in_flight(mix)
    for x in items[:flight]:
        # caught part way through an answer: the part answered is prompt
        assert x.arrive_step == 0 and x.max_new_tokens >= 1
        assert x.prompt_tokens + x.max_new_tokens \
            <= mix["prompt_tokens"]["max"] + mix["output_tokens"]["max"]
        assert x.prompt_tokens + x.max_new_tokens + 1 <= s["s_max"]
    for x in items[flight:]:
        q = x.prompt_tokens - (docs["tokens"] if docs else 0)
        assert mix["prompt_tokens"]["min"] <= q <= mix["prompt_tokens"]["max"]
        out = mix["output_tokens"]
        assert out["min"] <= x.max_new_tokens <= out["max"]
        assert x.prompt_tokens == len(x.prompt.encode()) + 1
        assert x.prompt_tokens + x.max_new_tokens + 1 <= s["s_max"]
        assert x.prompt.isascii()


def test_documents_are_asked_first():
    mix = _documents_mix()
    items = traffic.generate(mix, 9, 50)
    n = mix["documents"]["count"]
    assert [(x.doc, x.arrive_step) for x in items[:n]] == [(d, 0) for d in range(n)]


def test_documents_are_page_aligned_and_shared():
    mix = _documents_mix()
    docs = traffic.documents(mix, 3)
    items = traffic.generate(mix, 3, 200)
    ps = mix["serving"]["page_size"]
    for d in docs:
        assert (len(d) + 1) % ps == 0
    assert {x.doc for x in items} == set(range(mix["documents"]["count"]))
    for x in items:
        assert x.prompt.startswith(docs[x.doc])


@pytest.mark.parametrize("name", [m for m in MIXES
                                  if cells.mix(m).get("start") == "stationary"])
def test_a_stationary_start(name):
    mix = cells.mix(name)
    flight = traffic.in_flight(mix, traffic.master_block(mix))
    n = len(flight["prompt"])
    assert n == round(mix["load"] * mix["serving"]["max_batch"])
    # length-biased answers: those in flight are longer than the block's
    block = traffic.master_block(mix)
    total = flight["prompt"] + flight["output"]
    assert total.mean() > block["prompt"].mean() + block["output"].mean()
    items = traffic.generate(mix, 2 ** 40 + 3, 600)
    assert all(x.arrive_step == 0 for x in items[:n])
    start = mix["rehearsal"]["start_steps"]
    assert 0 < start < mix["rehearsal"]["warmup_steps"]
    assert all(x.arrive_step >= start for x in items[n:])
    other = traffic.generate(mix, 17, 600)
    assert sorted((x.prompt_tokens, x.max_new_tokens) for x in items[:n]) \
        == sorted((x.prompt_tokens, x.max_new_tokens) for x in other[:n])


@pytest.mark.parametrize("name", MIXES)
def test_rehearsal_written(name):
    r = cells.mix(name)["rehearsal"]
    load = cells.mix(name)["load"]
    assert r["rate_per_step"] == pytest.approx(load * r["slot_capacity_per_step"])
    assert r["warmup_steps"] > 0
    # no backlog grows: the second half waits about as long as the first
    assert r["second"]["queue_wait_steps_p95"] <= 3 * r["first"]["queue_wait_steps_p95"] + 10
