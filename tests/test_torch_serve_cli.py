"""`repro_torch.launch.serve` CLI on the CPU: every case of
tests/test_serve_cli.py against the port (request validation, structured
errors, the 0/1/2 exit codes), the `--smoke` run, and the refusal to run
without a GPU unless it is given `--device cpu`.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (EXIT_BAD_REQUEST,  # noqa: E402
                                      EXIT_FAIL, EXIT_OK, RequestError,
                                      parse_request)

CPU = ["--device", "cpu"]


class TestParseRequest:
    def test_minimal_defaults(self):
        kind, space, spec = parse_request({"techs": ["aos"], "layers": [87]})
        assert kind == "sweep" and spec == {}
        assert len(space) > 0

    def test_full_request(self):
        kind, space, spec = parse_request({
            "kind": "yield", "techs": ["aos"], "layers": [87, 137],
            "corners": {"rh_toggles": [1e5, 3e5]},
            "mc": {"samples": 8, "key": 3}, "replica": True,
            "spec": {"margin_mv": 5.0}})
        assert kind == "yield"
        assert space.mc is not None and space.mc.samples == 8
        assert space.replica
        assert dict(space.corner_axes)["rh_toggles"] == (1e5, 3e5)
        assert spec == {"margin_mv": 5.0}

    @pytest.mark.parametrize("obj,msg", [
        ([1, 2], "must be a JSON object"),
        ({"bogus": 1}, "unknown request key"),
        ({"techs": []}, "non-empty list"),
        ({"techs": ["not_a_tech"]}, "bad tech"),
        ({"schemes": ["not_a_scheme"]}, "bad scheme"),
        ({"layers": [0]}, "positive integers"),
        ({"layers": [4.5]}, "positive integers"),
        ({"mc": {"key": 1}}, "'samples'"),
        ({"corners": "hot"}, "'corners' must be"),
        ({"spec": ["margin_mv"]}, "'spec' must be"),
        ({"mc": {"samples": 8, "wat": 1}}, "invalid request"),
    ])
    def test_rejections(self, obj, msg):
        with pytest.raises(RequestError, match=msg):
            parse_request(obj)


class TestExitCodes:
    def test_served_ok(self, capsys):
        rc = serve.main(["--request",
                         '{"kind": "sweep", "techs": ["aos"],'
                         ' "layers": [87]}', "--stats"] + CPU)
        assert rc == EXIT_OK
        lines = [json.loads(ln)
                 for ln in capsys.readouterr().out.splitlines()]
        assert lines[0]["rows"] > 0 and lines[0]["kind"] == "sweep"
        assert lines[-1]["stats"]["requests"] == 1

    def test_malformed_json_exits_2(self, capsys):
        rc = serve.main(["--request", "{not json"] + CPU)
        assert rc == EXIT_BAD_REQUEST
        err = json.loads(capsys.readouterr().err.strip())
        assert err["error"]["code"] == "bad_request"

    def test_unknown_tech_exits_2(self, capsys):
        rc = serve.main(["--request", '{"techs": ["zzz"]}'] + CPU)
        assert rc == EXIT_BAD_REQUEST
        err = json.loads(capsys.readouterr().err.strip())
        assert err["error"]["code"] == "bad_request"
        assert err["error"]["request"] == 0

    def test_requests_file_jsonl_and_array(self, tmp_path, capsys):
        req = {"techs": ["aos"], "layers": [87]}
        jl = tmp_path / "reqs.jsonl"
        jl.write_text(json.dumps(req) + "\n")
        assert serve.main(["--requests-file", str(jl)] + CPU) == EXIT_OK
        arr = tmp_path / "reqs.json"
        arr.write_text(json.dumps([req]))
        assert serve.main(["--requests-file", str(arr)] + CPU) == EXIT_OK
        capsys.readouterr()
        assert serve.main(["--requests-file",
                           str(tmp_path / "missing.json")] + CPU) \
            == EXIT_BAD_REQUEST

    def test_engine_failure_exits_1(self, capsys, monkeypatch):
        from repro_torch.core import dse

        def boom(*a, **k):
            raise RuntimeError("engine fell over")

        monkeypatch.setattr(dse, "plan_sweep", boom)
        rc = serve.main(["--request", '{"techs": ["aos"], "layers": [87]}']
                        + CPU)
        assert rc == EXIT_FAIL
        err = json.loads(capsys.readouterr().err.strip())
        assert err["error"]["code"] == "serve_failed"
        assert "engine fell over" in err["error"]["message"]

    def test_json_output_file(self, tmp_path, capsys):
        out = tmp_path / "responses.json"
        rc = serve.main(["--request", '{"techs": ["aos"], "layers": [87]}',
                         "--json", str(out)] + CPU)
        assert rc == EXIT_OK
        payload = json.loads(out.read_text())
        assert payload["responses"][0]["rows"] > 0
        assert payload["stats"]["dispatches"] >= 0


def test_smoke_on_the_cpu_exits_0(capsys):
    assert serve.main(["--smoke", "--window-ms", "1"] + CPU) == EXIT_OK
    out = capsys.readouterr().out
    assert "2 clients, 1 dispatch" in out
    assert out.rstrip().endswith("serve smoke: OK")


def test_yield_request_reports_yield(capsys):
    rc = serve.main(["--request", json.dumps({
        "kind": "yield", "techs": ["aos"], "layers": [87],
        "mc": {"samples": 8, "key": 1}, "spec": {"margin_mv": 5.0}})] + CPU)
    assert rc == EXIT_OK
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rec["kind"] == "yield" and rec["rows"] == 4 * 8
    assert rec["yield"]["designs"] == 4


def test_cli_refuses_without_a_gpu():
    """Without a GPU the launcher raises unless it is asked for the CPU;
    the default device is "cuda"."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for argv in (["--smoke"],
                 ["--request", '{"techs": ["aos"], "layers": [87]}']):
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(argv)
