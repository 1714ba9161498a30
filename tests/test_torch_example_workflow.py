"""The port's example workflow (``examples/ancestry_workflow_torch.sh``)
run end to end on the CPU (``DEVICE=cpu``) in a scratch directory, its
step-4 panel coordinates held against the JAX CLI's ``pcoa`` on the same
packed store."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "ancestry_workflow_torch.sh")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **extra)
    return env


def _read_tsv(path: str):
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    assert rows[0][0] == "sample"  # the header: sample, pc1, ...
    body = rows[1:]
    return [r[0] for r in body], np.array([[float(x) for x in r[1:]]
                                           for r in body])


def test_the_workflow_runs_on_the_cpu_and_matches_the_jax_cli(tmp_path):
    res = subprocess.run(["bash", SCRIPT], cwd=tmp_path,
                         env=_env(DEVICE="cpu"), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = tmp_path / "workflow_out_torch"
    for name in ("panel.bed", "newcohort.bed", "labels.npy",
                 "panel_sample_stats.tsv", "cross_phi.tsv",
                 "panel_coords.tsv", "panel_model.npz",
                 "panel_coords_full.tsv", "new_coords.tsv"):
        assert (out / name).exists(), name
    assert "== done; outputs in workflow_out_torch ==" in res.stdout
    assert not (tmp_path / "workflow_out").exists()

    # Step 4 against the JAX CLI on the store step 3 wrote.
    jax_tsv = tmp_path / "jax_panel_coords.tsv"
    jres = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu", "pcoa", "--source",
         "packed", "--path", str(out / "panel_store"), "--num-pc", "4",
         "--output-path", str(jax_tsv)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=600)
    assert jres.returncode == 0, jres.stderr[-3000:]
    t_ids, t = _read_tsv(str(out / "panel_coords.tsv"))
    j_ids, j = _read_tsv(str(jax_tsv))
    assert t_ids == j_ids and t.shape == j.shape == (120, 4)
    if (out / "panel_coords.tsv").read_bytes() == jax_tsv.read_bytes():
        return
    # Else the port's stated tolerances (tests/test_torch_pipeline.py):
    # eigenvalues (a column's squared norm: coords = v sqrt(lambda))
    # within 1e-4 of lambda_1; each column with an eigengap above 2 % of
    # lambda_1 up to sign within 2e-3 of its scale, as far as the TSV's
    # digits carry.
    jv, tv = (j ** 2).sum(0), (t ** 2).sum(0)
    np.testing.assert_allclose(tv, jv, atol=1e-4 * jv[0])
    gaps = np.diff(jv)
    checked = 0
    for c in range(4):
        left = abs(gaps[c - 1]) if c > 0 else np.inf
        right = abs(gaps[c]) if c < 3 else np.inf
        if min(left, right) <= 0.02 * jv[0]:
            continue
        s = np.sign(np.dot(j[:, c], t[:, c])) or 1.0
        np.testing.assert_allclose(s * t[:, c], j[:, c],
                                   atol=2e-3 * np.abs(j[:, c]).max(),
                                   err_msg=f"pc{c + 1}")
        checked += 1
    assert checked >= 1
