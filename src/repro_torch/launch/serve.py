"""Co-design-as-a-service launcher: serve DSE sweep/yield queries from
one warm micro-batching engine (`serving.dse_service.DSEService`) on the
GPU (`--device cuda`, the default; `--device cpu` runs the plain PyTorch
path).  Port of `repro.launch.serve`.

    # one-shot: serve JSON requests (repeat --request, or a JSONL file)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --request '{"kind": "sweep", "techs": ["aos"], "layers": [4, 8]}' \
        --request '{"kind": "yield", "mc": {"samples": 256}, \
                    "spec": {"margin_mv": 5.0}}'

    # smoke: warm engine, 2 concurrent clients -> ONE fused dispatch,
    # results bit-identical to direct dse.sweep, repeat query memo-hit
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke

Every request queued in one invocation is served through the same
micro-batch window machinery concurrent clients would share: cache
misses pack into one fused dispatch per window, repeats answer from the
LRU memo.  Responses print as one JSON line per request (summary
scalars); `--json` writes the full per-request records plus the
service's `stats()` block.

Request schema (all keys optional except none; unknown keys rejected):

    kind           "sweep" (default) | "yield"
    techs          registered technology names (default: all)
    schemes        routing scheme names (default: per-tech allowed set)
    layers         layer counts to sweep (default: registry grid)
    corners        {axis: [values, ...]} corner fan-out
    mc             {"samples": N, "key": K, ...} Monte-Carlo declaration
                   (required for kind="yield"; extra keys pass through
                   to DesignSpace.with_mc)
    replica        true -> replica-closed SA timing
    with_transient false -> skip the transient engine (static metrics)
    spec           mc_summary kwargs for kind="yield" (margin_mv, ...)

Exit codes follow the `tools/bench_check.py` convention: 0 = all
requests served, 1 = a served request failed in the engine, 2 = a
malformed request (validation error, bad JSON, unreadable file).
Without a GPU the launcher raises unless it is given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys

EXIT_OK = 0
EXIT_FAIL = 1
EXIT_BAD_REQUEST = 2

REQUEST_KEYS = ("kind", "techs", "schemes", "layers", "corners", "mc",
                "replica", "with_transient", "spec")


class RequestError(Exception):
    """A request the service must reject: malformed JSON, unknown keys,
    unregistered names, invalid values.  Maps to exit code 2."""


def _structured_error(code: str, message: str, request=None) -> None:
    """One machine-readable error record on stderr (never a raw
    traceback — the launch/serve contract for malformed input)."""
    err = {"error": {"code": code, "message": message}}
    if request is not None:
        err["error"]["request"] = request
    print(json.dumps(err), file=sys.stderr)


def parse_request(obj):
    """Validate one JSON request object -> (kind, DesignSpace, spec).

    Names are validated through the registries' raising accessors
    (`cal.get_tech`, `routing.scheme_spec`) — an unknown name fails here
    with a `RequestError`, before anything is queued.
    """
    from ..core import calibration as cal
    from ..core import routing
    from ..core.space import DesignSpace

    if not isinstance(obj, dict):
        raise RequestError(f"request must be a JSON object, got "
                           f"{type(obj).__name__}")
    unknown = sorted(k for k in obj if k not in REQUEST_KEYS)
    if unknown:
        raise RequestError(f"unknown request key(s) {unknown}; "
                           f"allowed: {list(REQUEST_KEYS)}")

    kind = obj.get("kind", "sweep")
    techs = obj.get("techs")
    schemes = obj.get("schemes")
    layers = obj.get("layers")
    if techs is not None:
        if not isinstance(techs, list) or not techs:
            raise RequestError("'techs' must be a non-empty list of "
                               "registered technology names")
        for name in techs:
            try:
                cal.get_tech(name)
            except (KeyError, TypeError) as e:
                raise RequestError(f"bad tech in request: {e}") from None
    if schemes is not None:
        if not isinstance(schemes, list) or not schemes:
            raise RequestError("'schemes' must be a non-empty list of "
                               "routing scheme names")
        for name in schemes:
            try:
                routing.scheme_spec(name)
            except (ValueError, TypeError) as e:
                raise RequestError(f"bad scheme in request: {e}") from None
    if layers is not None:
        if (not isinstance(layers, list) or not layers
                or not all(isinstance(n, int) and not isinstance(n, bool)
                           and n >= 1 for n in layers)):
            raise RequestError("'layers' must be a non-empty list of "
                               "positive integers")
        layers = tuple(layers)

    try:
        space = DesignSpace.product(techs=techs, schemes=schemes,
                                    layers=layers)
        corners = obj.get("corners", {})
        if corners:
            if not isinstance(corners, dict):
                raise RequestError("'corners' must be an object "
                                   "{axis: [values, ...]}")
            space = space.with_corners(
                **{k: tuple(v) if isinstance(v, list) else (v,)
                   for k, v in corners.items()})
        mc = obj.get("mc")
        if mc is not None:
            if not isinstance(mc, dict) or "samples" not in mc:
                raise RequestError("'mc' must be an object with at least "
                                   "{'samples': N}")
            space = space.with_mc(**mc)
        if obj.get("replica", False):
            space = space.with_replica()
    except RequestError:
        raise
    except (TypeError, ValueError, KeyError) as e:
        raise RequestError(f"invalid request: {e}") from None

    spec = obj.get("spec", {})
    if not isinstance(spec, dict):
        raise RequestError("'spec' must be an object of mc_summary "
                           "keyword arguments")
    return kind, space, spec


def _summarize(i, req, resp) -> dict:
    """One JSON-serializable response record (summary scalars, not the
    full batch — use the library API for tensors)."""
    import numpy as np

    from ..device import to_host

    batch = resp.batch
    feasible = to_host(batch.feasible & batch.valid)
    rec = {
        "request": i,
        "kind": req.get("kind", "sweep"),
        "rows": len(batch),
        "feasible": int(feasible.sum()),
        "memo_hit": bool(resp.memo_hit),
        "elapsed_ms": round(resp.elapsed_ms, 3),
    }
    if feasible.any():
        dens = to_host(batch.density_gb_mm2)
        trc = to_host(batch.trc_ns)
        rec["max_density_gb_mm2"] = float(dens[feasible].max())
        if np.isfinite(trc[feasible]).any():
            rec["min_trc_ns"] = float(np.nanmin(trc[feasible]))
    if resp.summary is not None:
        yf = to_host(resp.summary.corners["yield_frac"])
        rec["yield"] = {
            "designs": len(resp.summary),
            "min_yield_frac": float(yf.min()),
            "max_yield_frac": float(yf.max()),
        }
    return rec


def _load_requests(args) -> list[dict]:
    """Collect request objects from --request strings and --requests-file
    (a JSON array, or one JSON object per line)."""
    objs = []
    for raw in args.request or ():
        try:
            objs.append(json.loads(raw))
        except json.JSONDecodeError as e:
            raise RequestError(f"--request is not valid JSON: {e}") from None
    if args.requests_file:
        try:
            with open(args.requests_file) as fh:
                text = fh.read()
        except OSError as e:
            raise RequestError(f"cannot read requests file: {e}") from None
        stripped = text.lstrip()
        try:
            if stripped.startswith("["):
                loaded = json.loads(text)
                if not isinstance(loaded, list):
                    raise RequestError("requests file: top-level JSON "
                                       "must be an array or JSONL")
                objs.extend(loaded)
            else:
                objs.extend(json.loads(line)
                            for line in text.splitlines() if line.strip())
        except json.JSONDecodeError as e:
            raise RequestError(
                f"requests file is not valid JSON/JSONL: {e}") from None
    return objs


def serve_requests(objs, args) -> int:
    """Queue every request on one warm engine, flush as micro-batch
    windows, print one summary line per response."""
    from ..serving.dse_service import DSEService

    parsed = []
    for i, obj in enumerate(objs):
        try:
            parsed.append(parse_request(obj))
        except RequestError as e:
            _structured_error("bad_request", str(e), request=i)
            return EXIT_BAD_REQUEST

    svc = DSEService(window_ms=args.window_ms, memo_entries=args.memo,
                     b_chunk=args.b_chunk, device=args.device)
    futures = [svc.submit(space, kind=kind, spec=spec)
               for kind, space, spec in parsed]
    svc.flush()

    status = EXIT_OK
    records = []
    for i, (obj, fut) in enumerate(zip(objs, futures)):
        try:
            resp = fut.result(timeout=0)
        except (ValueError, TypeError, KeyError) as e:
            _structured_error("bad_request", str(e), request=i)
            return EXIT_BAD_REQUEST
        except Exception as e:
            _structured_error("serve_failed",
                              f"{type(e).__name__}: {e}", request=i)
            status = EXIT_FAIL
            continue
        rec = _summarize(i, obj, resp)
        records.append(rec)
        print(json.dumps(rec))
    stats = svc.stats()
    if args.stats:
        print(json.dumps({"stats": stats}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"responses": records, "stats": stats}, f, indent=2)
        print(f"wrote {args.json}", file=sys.stderr)
    return status


def _batches_identical(a, b) -> bool:
    """NaN-aware bit-identity over every array field + corner channel."""
    import numpy as np

    from ..core.batch import ARRAY_FIELDS
    from ..device import to_host

    def eq(x, y):
        x, y = to_host(x), to_host(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype.kind == "f":
            return bool(((x == y) | (np.isnan(x) & np.isnan(y))).all())
        return bool((x == y).all())

    return (set(a.corners) == set(b.corners)
            and all(eq(getattr(a, f), getattr(b, f)) for f in ARRAY_FIELDS)
            and all(eq(a.corners[k], b.corners[k]) for k in a.corners))


def _smoke(window_ms: float, device="cuda") -> None:
    """The serving smoke: a warm engine on `device` serving two concurrent
    clients' mixed sweep/yield queries from ONE shared fused dispatch,
    bit-identical to direct `dse.sweep`, with a memo hit on repeat."""
    import threading
    import time

    from ..core import dse
    from ..core.space import DesignSpace
    from ..serving.dse_service import DSEService

    svc = DSEService(window_ms=window_ms, device=device)
    t0 = time.perf_counter()
    svc.warm()
    print(f"warm-up sweep (kernel build included) in "
          f"{time.perf_counter() - t0:.2f}s")

    # two concurrent clients (real threads, barrier-synchronized), mixed
    # query kinds, submitted into the same micro-batch window
    s_sweep = DesignSpace.product(techs=["aos"], layers=(4, 8, 16))
    s_yield = DesignSpace.paper_targets().with_mc(samples=32, key=1)
    before = svc.stats()
    barrier = threading.Barrier(2)
    futures = {}

    def client(name, submit):
        barrier.wait()
        futures[name] = submit()

    threads = [
        threading.Thread(target=client, args=(
            "sweep", lambda: svc.submit(s_sweep))),
        threading.Thread(target=client, args=(
            "yield", lambda: svc.submit(
                s_yield, kind="yield", spec={"margin_mv": 5.0}))),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    if any(t.is_alive() for t in threads) or len(futures) != 2:
        raise SystemExit("serve smoke: a client thread did not submit")
    svc.flush()
    after = svc.stats()
    if after["windows"] - before["windows"] != 1:
        raise SystemExit("serve smoke: expected ONE micro-batch window, "
                         f"got {after['windows'] - before['windows']}")
    if after["dispatches"] - before["dispatches"] != 1:
        raise SystemExit(
            "serve smoke: 2 concurrent clients did NOT share one fused "
            f"dispatch (got {after['dispatches'] - before['dispatches']})")

    r_sweep = futures["sweep"].result(timeout=0)
    r_yield = futures["yield"].result(timeout=0)
    if not _batches_identical(r_sweep.batch, dse.sweep(s_sweep,
                                                       device=device)):
        raise SystemExit("serve smoke: packed sweep response is NOT "
                         "bit-identical to direct dse.sweep")
    if not _batches_identical(r_yield.batch, dse.sweep(s_yield,
                                                       device=device)):
        raise SystemExit("serve smoke: packed yield response is NOT "
                         "bit-identical to direct dse.sweep")
    if r_yield.summary is None or "yield_frac" not in r_yield.summary.corners:
        raise SystemExit("serve smoke: yield query returned no summary")
    print(f"window smoke: 2 clients, 1 dispatch "
          f"({after['rows']['dispatched'] - before['rows']['dispatched']} "
          "packed rows), responses bit-identical to direct sweeps")

    # repeat query: answered from the memo, no new dispatch
    f_again = svc.submit(s_sweep)
    svc.flush()
    r_again = f_again.result(timeout=0)
    final = svc.stats()
    if not r_again.memo_hit:
        raise SystemExit("serve smoke: repeated query was not a memo hit")
    if final["dispatches"] != after["dispatches"]:
        raise SystemExit("serve smoke: repeated query re-dispatched "
                         "instead of answering from the memo")
    if not _batches_identical(r_again.batch, r_sweep.batch):
        raise SystemExit("serve smoke: memo hit returned a different batch")

    # background dispatcher liveness: blocking clients through the thread
    with DSEService(window_ms=window_ms, device=device) as bg:
        live = bg.sweep(s_sweep, timeout=60.0)
    if not _batches_identical(live, r_sweep.batch):
        raise SystemExit("serve smoke: dispatcher-thread result diverged")
    print(f"memo smoke: repeat answered from memo "
          f"(hit rate {final['memo']['hit_rate']:.2f}, "
          f"{final['dispatches']} dispatches for {final['requests']} "
          "requests)")
    print("serve smoke: OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--request", action="append",
                    help="one JSON request object (repeatable)")
    ap.add_argument("--requests-file",
                    help="JSON array or JSONL file of request objects")
    ap.add_argument("--window-ms", type=float, default=3.0,
                    help="micro-batch window length")
    ap.add_argument("--memo", type=int, default=64,
                    help="LRU memo capacity (entries; 0 disables)")
    ap.add_argument("--b-chunk", type=int, default=None,
                    help="fused-engine chunk size (B_ALIGN multiple)")
    ap.add_argument("--stats", action="store_true",
                    help="print the service stats() block after serving")
    ap.add_argument("--json", help="write full responses + stats to a file")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: concurrent shared dispatch + memo + "
                         "bit-identity checks")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (default cuda; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (from the command line: --device cpu)") \
            from None

    if args.b_chunk is None:
        from ..core.transient import DEFAULT_B_CHUNK
        args.b_chunk = DEFAULT_B_CHUNK

    if args.smoke:
        _smoke(window_ms=args.window_ms, device=args.device)
        return EXIT_OK

    try:
        objs = _load_requests(args)
    except RequestError as e:
        _structured_error("bad_request", str(e))
        return EXIT_BAD_REQUEST
    if not objs:
        ap.print_help()
        return EXIT_OK
    return serve_requests(objs, args)


if __name__ == "__main__":
    sys.exit(main())
