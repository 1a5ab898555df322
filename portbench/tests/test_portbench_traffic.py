"""The traffic generator: lengths in range, the same sizes every round
and every seed, and the closed loop's schedule."""
import collections
import threading

from portbench import traffic
from portbench.tests import tiny


def test_quantiles_stay_in_range_and_spread():
    d = {"dist": "loguniform", "min": 512, "max": 1024}
    q = traffic.quantiles(d, 64)
    assert min(q) >= 512 and max(q) <= 1024 and q == sorted(q)
    assert q[0] < 520 and q[-1] > 1010
    u = traffic.quantiles({"dist": "uniform", "min": 16, "max": 64}, 8)
    assert u == [19, 25, 31, 37, 43, 49, 55, 61]


def test_every_round_and_seed_has_the_same_sizes():
    t = tiny.traffic(rounds=5)
    a = traffic.clients(t, 1, 500)
    b = traffic.clients(t, 2 ** 33 + 7, 500)
    assert len(a) == t["clients"] and all(len(c) == 5 for c in a)
    for r in range(5):
        sa = collections.Counter(len(c[r][0]) for c in a)
        sb = collections.Counter(len(c[r][0]) for c in b)
        assert sa == sb
        assert sorted(c[r][1] for c in a) == sorted(c[r][1] for c in b)
    assert a != b
    assert a == traffic.clients(t, 1, 500)
    assert all(0 <= x < 500 for c in a for p, _ in c for x in p)


def test_closed_loop_sends_one_request_per_client_at_a_time():
    from portbench.harness import Driver

    class Engine:                       # records what the driver sends
        max_slots = 3

        class serve:
            prefill_chunk = 32

        def _decode_burst(self, *a, **k):
            pass

        def _prefill_chunk(self, *a, **k):
            pass

    t = tiny.traffic(rounds=3)
    drv = Driver(Engine(), traffic.clients(t, 5, 500), 8, False)
    waiter = threading.Thread(target=drv.start, args=(60.0, 60.0))
    waiter.start()
    first = [drv.inbox.get(timeout=10) for _ in range(t["clients"])]
    assert drv.inbox.empty()
    for req in first:                   # each first token opens the window
        drv._emit(("token", req.uid, 0, 1))
    waiter.join(10)
    assert drv.t_end == drv.t0 + 60.0

    class Fin:
        def __init__(self, req):
            self.request, self.tokens = req, [1]
    drv._emit(("finished", Fin(first[0])))
    assert drv.inbox.qsize() == 1
    nxt = drv.inbox.get()
    assert drv.recs[nxt.uid].client == drv.recs[first[0].uid].client
    assert list(nxt.prompt) == drv.plan[0][1][0]


def test_residual_first_wave_spreads_the_first_outputs():
    t = tiny.traffic(rounds=3, clients=16, max_slots=16,
                     output={"dist": "uniform", "min": 100, "max": 200},
                     first_wave="residual")
    a = traffic.clients(t, 3, 500)
    b = traffic.clients(t, 2 ** 40 + 1, 500)
    full = traffic.quantiles(t["output"], 16)
    first = sorted(c[0][1] for c in a)
    assert first == sorted(c[0][1] for c in b)        # same set every seed
    assert first == sorted(traffic.residuals(full))
    assert sorted(traffic.residuals(full)) != sorted(full)
    assert min(first) < 20 and max(first) > 130       # spread over a life
    assert all(1 <= r <= x for r, x in zip(traffic.residuals(full), full))
    for r in (1, 2):                                  # later rounds whole
        assert sorted(c[r][1] for c in a) == full
