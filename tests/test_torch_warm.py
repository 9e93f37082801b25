"""The port's warm start (``warm/manifest.py``, ``warm/prewarm.py``) on
the CPU:

- the manifest: for the same knobs, schemes, bucket cap and traffic the
  port lists the same (engine, shape, B, scheme) entries, dims and
  priorities in the same order as the JAX package's ``build_manifest``
  over its committed ``COMPILE_SURFACE.json``; ``knobs_from_config``,
  the traffic weights and the report's keys and totals are JAX's;
- the walk: a spent budget marks entries ``skipped``, a raising runner
  marks its entry ``failed`` and the walk goes on, a second pass finds
  ``already``; ``cache`` is K0's build verdict where an entry launched
  K0, the graphs' verdict where it captured or replayed graphs (with
  K0's as ``k0`` beside it); ``prewarm_for_daemon`` writes its report and never raises;
  ``warm_for_drill`` keeps its keys;
- the cheap real runners at bucket 1 on the CPU (every runner, the
  Paillier ones too, is slow-marked; ``chip_smoke.py`` runs them all on
  the card).
"""
import json
import os
import types

import pytest

from mpcium_tpu.warm import manifest as jwm
from mpcium_tpu.warm import prewarm as jpw
from mpcium_tpu_torch.ops import mulmod as K
from mpcium_tpu_torch.perf import compile_watch
from mpcium_tpu_torch.warm import manifest as wm
from mpcium_tpu_torch.warm import prewarm as pw

KNOBS = [
    dict(),
    dict(q=(3,), key_type=("secp256k1",), mta_impl=("ot",), t_new=(2,)),
    dict(q=(2, 3), t_new=(1, 2)),
]
FILTERS = [
    dict(),
    dict(schemes=("eddsa",), max_b=64),
    dict(schemes=("ecdsa", "dkg"), max_b=8),
    dict(schemes=("reshare",), max_b=1),
]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with nothing run and an empty compile ledger."""
    saved = set(pw._RAN)
    pw._RAN.clear()
    compile_watch.reset()
    yield
    pw._RAN.clear()
    pw._RAN.update(saved)
    compile_watch.reset()


def _traffic(tmp_path):
    ledger = tmp_path / "COMPILE_LEDGER.json"
    ledger.write_text(json.dumps({"entries": [
        {"engine": "eddsa.sign", "shape": "B64|q2"},
        {"engine": "eddsa.sign", "shape": "B64|q2"},
        {"engine": "gg18.sign", "shape": "B8|q2|mta=ot"},
        {"engine": "mulmod", "shape": "0123abcd"},
        {"engine": 7, "shape": None},
    ]}))
    history = tmp_path / "history.jsonl"
    history.write_text("\n".join([json.dumps({"context": {"batch": 4}}),
                                  "not json", "",
                                  json.dumps({"context": {"ed25519_batch": 16,
                                                          "dkg_batch": 4}})]))
    return str(ledger), str(history)


def _entries(manifest):
    return [(e["engine"], e["shape"], e["B"], e["scheme"], e["dims"], e["priority"])
            for e in manifest["entries"]]


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("knobs", KNOBS)
def test_manifest_equals_the_jax_manifest(tmp_path, knobs, filters):
    traffic = wm.load_traffic(*_traffic(tmp_path))
    assert traffic == jwm.load_traffic(*_traffic(tmp_path))
    got = wm.build_manifest(wm.WarmKnobs(**knobs), traffic=traffic, **filters)
    want = jwm.build_manifest(jwm.load_default_surface(), jwm.WarmKnobs(**knobs),
                              traffic=traffic, **filters)
    assert _entries(got) == _entries(want) and got["entries"]
    for k in ("knobs", "buckets", "schemes", "counts", "gaps"):
        assert got[k] == want[k], k
    assert got["key"]["host"] == want["key"]["host"]


def test_an_empty_knob_is_a_gap_in_both_packages():
    got = wm.build_manifest(wm.WarmKnobs(mta_impl=()), schemes=("ecdsa",))
    want = jwm.build_manifest(jwm.load_default_surface(), jwm.WarmKnobs(mta_impl=()),
                              schemes=("ecdsa",))
    assert _entries(got) == _entries(want)
    assert [g.split(" (")[0] for g in got["gaps"]] == [g.split(" (")[0] for g in want["gaps"]]
    assert got["gaps"] and not any(e[0] == "gg18.sign" for e in _entries(got))


def test_the_serving_templates_are_the_surface_s():
    surface = jwm.load_default_surface()["engines"]
    serving = {eng: rec["template"] for eng, recs in surface.items() for rec in recs
               if rec.get("serving")}
    assert wm.SERVING_TEMPLATES == serving
    assert "party.eddsa" not in wm.SERVING_TEMPLATES
    assert wm.ENGINE_SCHEME == jwm.ENGINE_SCHEME and wm.ALL_SCHEMES == jwm.ALL_SCHEMES
    assert wm.REPORT_BASENAME == jwm.REPORT_BASENAME
    assert set(pw.RUNNERS) == set(jpw.RUNNERS) == set(wm.SERVING_TEMPLATES)


@pytest.mark.parametrize("mta", [None, "paillier", "ot"])
@pytest.mark.parametrize("threshold", [1, 2, 4])
def test_knobs_from_config_equal_jax(monkeypatch, threshold, mta):
    if mta is None:
        monkeypatch.delenv("MPCIUM_MTA", raising=False)
    else:
        monkeypatch.setenv("MPCIUM_MTA", mta)
    cfg = types.SimpleNamespace(mpc_threshold=threshold)
    assert wm.knobs_from_config(cfg).to_json() == jwm.knobs_from_config(cfg).to_json()
    with pytest.raises(ValueError):
        wm.default_knobs(0)


def test_manifest_key_names_host_torch_and_cuda():
    import torch

    key = wm.manifest_key()
    assert key == {"host": jwm.manifest_key()["host"], "torch": torch.__version__,
                   "cuda": torch.version.cuda}
    assert wm.key_matches(key) == (True, "ok")
    assert wm.key_matches(None)[0] is False
    ok, why = wm.key_matches({**key, "torch": "0.0"})
    assert not ok and why.startswith("torch changed")


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _manifest(buckets=(1, 2), schemes=("eddsa",)):
    return wm.build_manifest(wm.WarmKnobs(), buckets=buckets, schemes=schemes)


def _eddsa_and_dkg_engines(buckets):
    """The manifest's eddsa.sign and ed25519 dkg.run entries (their
    scheme filter brings party.dkg along)."""
    m = wm.build_manifest(wm.WarmKnobs(key_type=("ed25519",)), buckets=buckets,
                          schemes=("eddsa", "dkg"))
    m["entries"] = [e for e in m["entries"] if e["engine"] in ("eddsa.sign", "dkg.run")]
    return m


def test_report_keys_and_totals_equal_jax(tmp_path):
    """A spent budget on both packages: same top-level keys, totals and
    verdicts, and the same file name."""
    got = pw.prewarm(_manifest(), 0.0, report_dir=str(tmp_path / "port"), device="cpu")
    want = jpw.prewarm(jwm.build_manifest(jwm.load_default_surface(), jwm.WarmKnobs(),
                                          buckets=(1, 2), schemes=("eddsa",)),
                       0.0, report_dir=str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert got["totals"] == want["totals"] == {
        "entries": 2, "warmed": 0, "already": 0, "skipped": 2, "failed": 0,
        "hits": 0, "misses": 0, "unpredicted": 0}
    assert [(r["engine"], r["shape"], r["status"], r["reason"]) for r in got["results"]] == \
        [(r["engine"], r["shape"], r["status"], r["reason"]) for r in want["results"]]
    files = [json.loads((tmp_path / d / wm.REPORT_BASENAME).read_text()) for d in ("port", "jax")]
    assert sorted(files[0]) == sorted(files[1]) == ["budget_s", "comment", "key", "results",
                                                    "totals"]


def test_budget_failures_and_already(monkeypatch):
    """A runner that raises fails its entry and the walk goes on; the
    budget cuts the rest; a second pass finds what ran ``already``."""
    ran = []

    def ok(e, dev):
        ran.append((e.shape, str(dev)))

    def boom(e, dev):
        raise ValueError("warm runner down")

    monkeypatch.setitem(pw.RUNNERS, "eddsa.sign", ok)
    monkeypatch.setitem(pw.RUNNERS, "dkg.run", boom)
    clock = iter(range(100))
    m = _eddsa_and_dkg_engines((1, 2, 4))
    # entries by B then engine: dkg B1, eddsa B1, dkg B2, eddsa B2, dkg B4, eddsa B4
    rep = pw.prewarm(m, 9.5, device="cpu", now=lambda: float(next(clock)))
    status = [(r["engine"], r["B"], r["status"]) for r in rep["results"]]
    assert status == [("dkg.run", 1, "failed"), ("eddsa.sign", 1, "warmed"),
                      ("dkg.run", 2, "failed"), ("eddsa.sign", 2, "warmed"),
                      ("dkg.run", 4, "skipped"), ("eddsa.sign", 4, "skipped")]
    assert "warm runner down" in rep["results"][0]["reason"]
    assert rep["totals"]["failed"] == 2 and rep["totals"]["skipped"] == 2
    assert ran == [("B1|q2", "cpu"), ("B2|q2", "cpu")]
    again = pw.prewarm(m, 1e9, device="cpu")
    assert [r["status"] for r in again["results"]] == [
        "failed", "already", "failed", "already", "failed", "warmed"]
    assert again["totals"]["already"] == 2 and ran[-1] == ("B4|q2", "cpu")


def test_cache_is_k0_s_build_verdict_where_k0_launched(monkeypatch):
    def k0_build_and_launch(e, dev):
        compile_watch.finish(compile_watch.begin("mulmod", "digest"), "miss")
        with K._count_lock:
            K.launches += 1

    def k0_launch(e, dev):
        with K._count_lock:
            K.launches += 1

    monkeypatch.setitem(pw.RUNNERS, "eddsa.sign", k0_build_and_launch)
    rep = pw.prewarm(_manifest(buckets=(1,)), 60, device="cpu")
    assert rep["results"][0]["cache"] == "miss" and "compile_s" in rep["results"][0]
    monkeypatch.setitem(pw.RUNNERS, "eddsa.sign", k0_launch)
    monkeypatch.setitem(pw.RUNNERS, "dkg.run", lambda e, dev: None)
    rep = pw.prewarm(_eddsa_and_dkg_engines((2,)), 60, device="cpu")
    assert [(r["engine"], r["cache"], "compile_s" in r) for r in rep["results"]] == [
        ("dkg.run", "none", False), ("eddsa.sign", "miss", False)]
    assert rep["totals"]["misses"] == 1 and rep["totals"]["hits"] == 0
    K.reset_counters()


def test_a_graphed_entry_keeps_k0_s_verdict_beside_its_graphs(monkeypatch):
    """An ECDSA entry launches K0 and captures GG18 graphs: its row has
    both verdicts; an entry that only captures has no ``k0`` and no
    ``compile_s`` (its ledger entries are captures, not K0's build)."""
    import torch
    from test_torch_graphs import StandIn

    from mpcium_tpu_torch.core import bignum as bn
    from mpcium_tpu_torch.engine import gg18_batch as gb
    from mpcium_tpu_torch.engine import graphs

    def bits(B):
        gb._bits_pack(torch.zeros(B, 14, dtype=torch.int32), bn.LimbProfile(bits=7, n_limbs=2))

    def k0_and_graphs(e, dev):
        compile_watch.finish(compile_watch.begin("mulmod", "digest"), "miss")
        with K._count_lock:
            K.launches += 1
        bits(2)

    monkeypatch.setitem(pw.RUNNERS, "dkg.run", k0_and_graphs)
    monkeypatch.setitem(pw.RUNNERS, "eddsa.sign", lambda e, dev: (bits(2), bits(3)))
    graphs.clear()
    try:
        with graphs.use_backend(StandIn()):
            rep = pw.prewarm(_eddsa_and_dkg_engines((2,)), 60, device="cpu")
    finally:
        graphs.clear()
        K.reset_counters()
    assert [(r["engine"], r["cache"], r["graphs"], r.get("k0"), "compile_s" in r)
            for r in rep["results"]] == [
        ("dkg.run", "miss", {"hits": 0, "misses": 1}, "miss", True),
        ("eddsa.sign", "miss", {"hits": 1, "misses": 1}, None, False)]
    assert rep["totals"]["hits"] == 1 and rep["totals"]["misses"] == 2


def test_prewarm_needs_a_device_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pw.prewarm(_manifest(), 60)
    assert pw.warm_for_drill()["warmed"] == 0  # the drill's pass never raises


def test_cheap_runners_on_the_cpu_then_already():
    """Every DKG / reshare runner of both curves that needs no Paillier
    material, and the EdDSA engine, at bucket 1 on the CPU."""
    knobs = wm.WarmKnobs(key_type=("ed25519",))
    m = wm.build_manifest(knobs, buckets=(1,))
    m["entries"] += wm.build_manifest(wm.WarmKnobs(key_type=("secp256k1",)), buckets=(1,),
                                      schemes=("dkg", "reshare"))["entries"]
    m["entries"] = [e for e in m["entries"] if e["engine"] not in ("gg18.sign", "party.ecdsa")
                    and not (e["engine"].startswith("party.") and "secp256k1" in e["shape"])]
    rep = pw.prewarm(m, 600, device="cpu")
    assert rep["totals"]["failed"] == 0 and rep["totals"]["warmed"] == len(m["entries"]) == 7
    assert {r["cache"] for r in rep["results"]} == {"none"}
    assert all(r["warm_s"] >= 0 for r in rep["results"])
    assert pw.prewarm(m, 600, device="cpu")["totals"]["already"] == 7


@pytest.mark.slow
def test_every_runner_on_the_cpu():
    """All twelve entries of the four schemes at bucket 1 (q=2, both
    curves, both MtA backends): a few minutes on the CPU."""
    m = wm.build_manifest(wm.WarmKnobs(), buckets=(1,))
    rep = pw.prewarm(m, 3600, device="cpu")
    assert rep["totals"]["warmed"] == rep["totals"]["entries"] == 12, rep["results"]


def test_warm_for_drill_keeps_its_keys():
    first = pw.warm_for_drill(device="cpu")
    assert first == {"warmed": 1, "hits": 0, "budget_s": 60.0}
    assert pw.warm_for_drill(device="cpu") == {"warmed": 1, "hits": 1, "budget_s": 60.0}
    assert ("eddsa.sign", "B2|q2", "cpu") in pw._RAN


def test_prewarm_for_daemon_writes_its_report_and_never_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("MPCIUM_MTA", raising=False)
    monkeypatch.setitem(pw.RUNNERS, "eddsa.sign", lambda e, dev: None)
    cfg = types.SimpleNamespace(db_dir=str(tmp_path), warm_cache_dir="", mpc_threshold=1,
                                warm_schemes="eddsa", warm_max_b=4, warm_budget_s=60.0)
    rep = pw.prewarm_for_daemon(cfg, "node0", "cpu")
    path = os.path.join(pw.default_cache_dir(str(tmp_path / "node0")), wm.REPORT_BASENAME)
    assert rep["path"] == path and json.loads(open(path).read())["totals"]["warmed"] == 3
    assert [r["shape"] for r in rep["results"]] == ["B1|q2", "B2|q2", "B4|q2"]
    cfg.warm_cache_dir = str(tmp_path / "elsewhere")
    cfg.warm_schemes = ""  # all schemes
    monkeypatch.setattr(pw, "RUNNERS", {k: (lambda e, dev: None) for k in pw.RUNNERS})
    rep = pw.prewarm_for_daemon(cfg, "node0", "cpu")
    assert rep["path"].startswith(cfg.warm_cache_dir)
    assert rep["totals"]["entries"] == 36 and rep["totals"]["already"] == 3  # the eddsa ones
    assert rep["totals"]["warmed"] == 33
    cfg.warm_schemes = None  # a broken config: logged, the node serves cold
    assert pw.prewarm_for_daemon(cfg, "node0", "cpu") is None
