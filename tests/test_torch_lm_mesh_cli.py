"""``python -m repro_torch.lm.launch.train --mesh 2,2`` under ``torchrun``
on the CPU: 4 gloo ranks train the reduced minitron sharded for 2 steps,
exit 0, and rank 0 alone prints the history rows."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_train_cli_mesh_under_torchrun(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.lm.launch.train",
         "--mesh", "2,2", "--arch", "minitron-4b", "--reduced",
         "--device", "cpu", "--steps", "2", "--ckpt-dir",
         str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-6000:]
    rows = [line for line in res.stdout.splitlines()
            if line.startswith("step=")]
    assert len(rows) == 1 and rows[0].startswith("step=1,ce="), res.stdout
    assert (tmp_path / "ckpt").is_dir()
