"""chip_smoke.py's host oracles and its refusals, on the CPU: it must fail
without a GPU and outside a checkout, and its exact host references must
agree with the big-int oracle."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import spasm_tpu as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("p", [42013, 2147483629])
def test_smoke_host_modmatmul_exact(p, rng):
    f = st.field(p)
    a = f.rand((40, 300), rng)
    b = f.rand((300, 30), rng)
    a[0] = f.halfp
    b[:, 0] = f.mhalfp
    want = f.normalize(a.astype(object) @ b.astype(object)).astype(np.int64)
    np.testing.assert_array_equal(chip_smoke.host_modmatmul(p, a, b), want)


def test_smoke_kernel_is_null(rng):
    from spasm_tpu.fixtures import simplex_boundary

    A = simplex_boundary(9, 3)
    K = st.kernel(A)
    assert K.shape[0] > 0
    assert chip_smoke.kernel_is_null(A, K, A.field.p, rng)
    bad = K.to_scipy().tolil()
    bad[0, 0] = (bad[0, 0] + 1) % A.field.p
    bad = st.SparseGFp.from_scipy(bad.tocsr(), A.field.p)
    assert not chip_smoke.kernel_is_null(A, bad, A.field.p, rng)


def test_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phase",
         "identity"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "needs 1 GPU" in out.stdout
