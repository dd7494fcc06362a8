"""The port's CLI and job submission end to end: the cases of
``tests/test_cli_jobs.py`` through ``python -m ray_tpu_torch`` (the CLI
starts its own head from the shell, as a user would, with ``--num-gpus 0``
for the reference's ``--num-tpus``) and ``ray_tpu_torch.job_submission``.
Beside them: the port's ``stop`` leaves a reference session running
beside it alone, and ``--help`` lists every command of the reference's
CLI.
"""

import json
import os
import subprocess
import sys
import time

from ray_tpu_torch.job_submission import JobSubmissionClient


def _cli(args, env, timeout=120, pkg="ray_tpu_torch"):
    return subprocess.run(
        [sys.executable, "-m", pkg, *args],
        capture_output=True, text=True, timeout=timeout, env=env,
    )


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_cli_start_status_submit_stop(tmp_path):
    env = dict(os.environ)
    env["HOME"] = str(tmp_path)  # isolate ~/.ray_tpu_torch state
    from ray_tpu_torch._private.node import package_env

    env = package_env(env)
    for key in ("RAY_TPU_TORCH_CLUSTER_TOKEN", "RAY_TPU_TORCH_GCS_ADDR"):
        env.pop(key, None)

    out = _cli(["start", "--head", "--num-cpus", "2", "--num-gpus", "0"],
               env)
    assert out.returncode == 0, out.stderr
    assert "started head node" in out.stdout
    reference = None
    try:
        out = _cli(["status"], env)
        assert out.returncode == 0, out.stderr
        assert "1/1 nodes alive" in out.stdout

        out = _cli(
            ["submit", "--timeout", "120", "--",
             "python", "-c", "print('job says hello')"],
            env,
        )
        assert out.returncode == 0, out.stderr + out.stdout
        assert "job says hello" in out.stdout
        assert "SUCCEEDED" in out.stdout

        out = _cli(
            ["submit", "--timeout", "120", "--",
             "python", "-c", "raise SystemExit(3)"],
            env,
        )
        assert out.returncode == 1
        assert "FAILED" in out.stdout

        out = _cli(["job", "list"], env)
        assert out.returncode == 0, out.stderr
        assert out.stdout.count("raysubmit_") == 2

        # a reference session beside the port's, under the same HOME
        ref = _cli(["start", "--head", "--num-cpus", "1"], env,
                   pkg="ray_tpu")
        assert ref.returncode == 0, ref.stderr
        with open(tmp_path / ".ray_tpu" / "cluster.json") as f:
            reference = json.load(f)
    finally:
        out = _cli(["stop"], env)
    assert out.returncode == 0, out.stderr
    assert "stopped" in out.stdout
    try:
        time.sleep(1.0)
        # the port's sweep (``ray_tpu_torch._private.*<session>``) spared
        # every process of the reference's session
        assert reference and all(_alive(p) for p in reference["pids"])
        out = _cli(["status"], env, pkg="ray_tpu")
        assert out.returncode == 0 and "1/1 nodes alive" in out.stdout, \
            out.stderr
    finally:
        _cli(["stop"], env, pkg="ray_tpu")


def test_help_lists_every_command_of_the_reference():
    from ray_tpu.scripts import cli as ref_cli
    from ray_tpu_torch.scripts import cli

    def commands(module):
        parser_calls = []
        real = module.argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            parser_calls.append(self)
            raise SystemExit(0)

        module.argparse.ArgumentParser.parse_args = capture
        try:
            try:
                module.main([])
            except SystemExit:
                pass
        finally:
            module.argparse.ArgumentParser.parse_args = real
        sub = [a for a in parser_calls[0]._actions
               if a.__class__.__name__ == "_SubParsersAction"][0]
        return {name: p for name, p in sub.choices.items()}

    port, ref = commands(cli), commands(ref_cli)
    assert set(port) == set(ref)
    for name, parser in ref.items():
        flags = {o for a in parser._actions for o in a.option_strings}
        got = {o for a in port[name]._actions for o in a.option_strings}
        assert got == {"--num-gpus" if f == "--num-tpus" else f
                       for f in flags}, name
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    for name in ref:
        assert name in out.stdout
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "start",
                          "--help"], capture_output=True, text=True,
                         timeout=60)
    assert "--num-gpus" in out.stdout and "--num-tpus" not in out.stdout


def test_job_client_python_api(tmp_path):
    """JobSubmissionClient against a cluster of the port's Cluster:
    submit, poll, logs, stop, including a job that connects back into the
    cluster with address='auto'."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=1)
        cluster.wait_for_nodes()

        client = JobSubmissionClient(cluster.address)
        script = (
            "import ray_tpu_torch; ray_tpu_torch.init(address='auto');"
            "print('cpus', int(ray_tpu_torch.cluster_resources()['CPU']))"
        )
        sid = client.submit_job(
            entrypoint=f"{sys.executable} -c \"{script}\"")
        status = client.wait_until_finished(sid, timeout=180)
        logs = client.get_job_logs(sid)
        assert status == "SUCCEEDED", logs
        assert "cpus 3" in logs

        sid2 = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(300)'"
        )
        deadline = time.monotonic() + 60
        while client.get_job_status(sid2) == "PENDING":
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert client.stop_job(sid2)
        assert client.wait_until_finished(sid2, timeout=60) == "STOPPED"
        jobs = client.list_jobs()
        assert {j["submission_id"] for j in jobs} >= {sid, sid2}
        assert all(j["submission_id"].startswith("raysubmit_")
                   for j in jobs)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
