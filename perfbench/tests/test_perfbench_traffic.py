"""The generators are deterministic in `--seed` and draw what each mix
declares: the configuration's space under a fresh MC key each time."""

from __future__ import annotations

import itertools

import pytest

from conftest import SEED, with_parked


@pytest.fixture
def bench(bench):
    """The benchmark with its parked service cell, whose mix is tested."""
    return with_parked(bench)


@pytest.fixture
def grid(bench):
    from perfbench import harness
    return harness.cell_spec(bench, "grid-mc4096.service")


def take(gen, n):
    return list(itertools.islice(gen, n))


def keys(decls):
    return [kw["key"] for d in decls for name, kw in d if name == "with_mc"]


def test_keys_repeat_with_the_seed_and_differ_across_it(grid):
    from perfbench import drive
    space = grid["config"]["space"]
    a = take(drive.decls(space, drive.rng(SEED, "window")), 4)
    b = take(drive.decls(space, drive.rng(SEED, "window")), 4)
    c = take(drive.decls(space, drive.rng(SEED + 1, "window")), 4)
    assert a == b
    assert len(set(keys(a))) == 4                 # a fresh key each time
    assert keys(a) != keys(c)
    strip = lambda d: [[n, {k: v for k, v in kw.items() if k != "key"}]
                       for n, kw in d]
    assert all(strip(d) == space for d in a)      # the space as declared


def test_streams_are_independent(grid):
    from perfbench import drive
    space = grid["config"]["space"]
    warm = take(drive.decls(space, drive.rng(SEED, "warm")), 1)
    win = take(drive.decls(space, drive.rng(SEED, "window")), 1)
    clients = [take(drive.decls(space, drive.rng(SEED, "client", i)), 1)
               for i in range(3)]
    assert len(set(keys(warm + win + sum(clients, [])))) == 5


@pytest.mark.parametrize("seed", [0, SEED, -7, 2**40 + 3])
def test_any_whole_seed_works(grid, seed):
    from perfbench import drive
    assert len(keys(take(drive.decls(grid["config"]["space"],
                                     drive.rng(seed, "client", 2)), 3))) == 3


def test_service_clients_send_the_readme_query(grid):
    from perfbench.spaces import reference_space, with_key
    mix = grid["mix"]
    assert mix.CLIENTS == 8 and mix.WINDOW_MS == 3.0
    assert mix.MARGIN_MV == 80.0
    space = reference_space(with_key(grid["config"]["space"], 3))
    assert len(space) == 299_008                   # the whole paper grid


def test_reservoir_is_seeded_and_uniform():
    from perfbench import drive
    hits = [0] * 10
    for rep in range(2000):
        r = drive.Reservoir(1, drive.rng(rep, "sample"))
        for i in range(10):
            r.offer(i)
        hits[r.items[0]] += 1
    assert min(hits) > 120 and max(hits) < 280
    a, b = (drive.Reservoir(2, drive.rng(SEED, "sample")) for _ in range(2))
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items
