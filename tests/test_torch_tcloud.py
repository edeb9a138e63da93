"""The port's ``tcloud`` CLI (``repro_torch/core/tcloud.py``) against the
reference's: the demo's status table column for column (the plan hash in a
torch job's id differs by design: a torch spec does not hash as a JAX
spec), ``hash`` of shell and train specs, ``submit --watch`` of a spec
file, and ``demo_specs()`` field for field with only the backends
mapped."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.core import tcloud as ref_tcloud
from repro_torch.core import tcloud

BACKENDS = {"jax_train": "torch_train", "jax_serve": "torch_serve",
            "shell": "shell"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(out):
    """The status table's rows as dicts, from the header line on."""
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("id "))
    cols = lines[head].split()
    rows = []
    for ln in lines[head + 1:]:
        if not ln.strip():
            break
        rows.append(dict(zip(cols, ln.split())))
    return rows


def _logs(out):
    """{job id: its log lines} from the ``--- logs <id> ---`` sections."""
    logs, cur = {}, None
    for ln in out.splitlines():
        if ln.startswith("--- logs "):
            cur = ln.split()[2]
            logs[cur] = []
        elif cur is not None and ln.strip():
            logs[cur].append(ln)
    return logs


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_demo_status_table_equals_reference(tmp_path, capsys):
    ref = _run(ref_tcloud.main, ["--cluster-root", str(tmp_path / "ref"),
                                 "demo"], capsys)
    port = _run(tcloud.main, ["--cluster-root", str(tmp_path / "port"),
                              "--device", "cpu", "demo"], capsys)
    rt, pt = _table(ref), _table(port)
    assert len(pt) == len(rt) == 3
    for p, r in zip(pt, rt):
        assert {k: v for k, v in p.items() if k != "id"} == \
            {k: v for k, v in r.items() if k != "id"}
        assert p["id"][:8] == r["id"][:8]          # job-NNNN
    assert [r["progress"] for r in pt] == ["40/40", "4/4", "1/1"]
    assert {r["state"] for r in pt} == {"COMPLETED"}
    # the shell job's spec hashes alike in both packages, so its id does too
    assert pt[2]["id"] == rt[2]["id"]
    logs = _logs(port)
    train, serve, shell = (logs[r["id"]] for r in pt)
    assert any("checkpoint" in ln for ln in train)
    assert any("served" in ln for ln in serve)
    assert any("hello from TACC" in ln for ln in shell)
    # the same quanta and checkpoints, step for step (the plan hash and
    # the losses differ: each framework draws its own initial state)

    def events(lines):
        return [ln.split("] ", 1)[1].split(" loss=")[0].split(" (plan ")[0]
                for ln in lines]

    assert events(train) == events(_logs(ref)[rt[0]["id"]])
    assert events(train)[-2:] == ["step 40", "checkpoint @ step 40"]


def _spec_file(path, specs):
    path.write_text(json.dumps([s.to_dict() for s in specs]))
    return str(path)


def test_hash_of_shell_and_train_specs(tmp_path, capsys):
    shell = [s for s in ref_tcloud.demo_specs()
             if s.runtime.backend == "shell"]
    ref_path = _spec_file(tmp_path / "ref.json", ref_tcloud.demo_specs())
    port_path = _spec_file(tmp_path / "port.json", tcloud.demo_specs())
    shell_path = _spec_file(tmp_path / "shell.json", shell)
    ref_out = _run(ref_tcloud.main, ["hash", shell_path], capsys)
    assert _run(tcloud.main, ["hash", shell_path], capsys) == ref_out
    assert ref_out.split()[0] == shell[0].spec_hash()
    ref_lines = _run(ref_tcloud.main, ["hash", ref_path], capsys).splitlines()
    port_lines = _run(tcloud.main, ["hash", port_path],
                      capsys).splitlines()
    assert [ln.split()[1] for ln in port_lines] == \
        [ln.split()[1] for ln in ref_lines]
    # train and serve differ from the JAX specs' hashes; shell does not
    assert port_lines[0].split()[0] != ref_lines[0].split()[0]
    assert port_lines[1].split()[0] != ref_lines[1].split()[0]
    assert port_lines[2] == ref_lines[2]
    for ln, spec in zip(port_lines, tcloud.demo_specs()):
        assert ln.split()[0] == spec.spec_hash()


def test_submit_watch_runs_a_spec_file(tmp_path, capsys):
    from repro_torch.core import ResourceSpec, RuntimeEnv, TaskSpec
    specs = [
        TaskSpec(name="train-small", tenant="lab-a",
                 resources=ResourceSpec(chips=2),
                 runtime=RuntimeEnv(backend="torch_train",
                                    checkpoint_interval_steps=2),
                 entry={"arch": "tacc-100m", "smoke": True,
                        "global_batch": 2, "seq_len": 16}, total_steps=4),
        TaskSpec(name="echo", tenant="lab-b",
                 resources=ResourceSpec(chips=1),
                 runtime=RuntimeEnv(backend="shell"), entry={},
                 artifacts={"main": "print('echo ok')"}, total_steps=1)]
    path = _spec_file(tmp_path / "specs.json", specs)
    out = _run(tcloud.main, ["--cluster-root", str(tmp_path / "c"),
                             "--device", "cpu", "--policy", "fifo",
                             "submit", path, "--watch", "--quantum", "2"],
               capsys)
    for s in specs:
        assert f"submitted {s.name} -> " in out
        assert f"(spec hash {s.spec_hash()})" in out
    table = _table(out)
    assert [(r["name"], r["state"], r["progress"]) for r in table] == \
        [("train-small", "COMPLETED", "4/4"), ("echo", "COMPLETED", "1/1")]
    logs = _logs(out)
    assert sum("checkpoint @ step" in ln
               for ln in logs[table[0]["id"]]) >= 2
    assert any("echo ok" in ln for ln in logs[table[1]["id"]])


def test_demo_specs_equal_reference_with_backends_mapped():
    ref, port = ref_tcloud.demo_specs(), tcloud.demo_specs()
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        want = r.to_dict()
        want["runtime"]["backend"] = BACKENDS[want["runtime"]["backend"]]
        assert p.to_dict() == want
        p.validate()


def test_cli_arguments_equal_reference(capsys):
    """The same commands, options and defaults, plus ``--device``."""
    for main in (ref_tcloud.main, tcloud.main):
        with pytest.raises(SystemExit):
            main(["--help"])
    ref_help, port_help = (capsys.readouterr().out.split("usage: tcloud")[1:])
    for opt in ("--cluster-root", "--policy", "{submit,demo,hash}"):
        assert opt in ref_help and opt in port_help
    assert "--device" in port_help and "--device" not in ref_help
