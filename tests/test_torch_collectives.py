"""The port's ring collectives (``core/pipeline_collectives.py``) on 4 gloo
ranks against the reference's ``ppermute`` rings on 4 fake devices, on the
same seeded inputs: the all-gather bitwise, the reduce-scatter and the two
overlapped matmuls at the reference's rtol 1e-5, n - 1 hops a rank, and
the reference's ``ValueError`` on an indivisible dim. A ring of 2 (the
model dim of a (2, 2) mesh, whose groups map to global ranks {0, 1} and
{2, 3}) is held against numpy.

The four ranks are started once for the module (``torch_dist_ranks.py``)
and the reference runs once in a subprocess; every case reads the shared
results."""

import re

import numpy as np
import pytest

from conftest import run_in_subprocess
from torch_dist_ranks import WORLD, spawn_ranks

RTOL = 1e-5  # the reference's tolerance for the summed rings

_JAX_CODE = r"""
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map
from repro.core import pipeline_collectives as pc

f = np.load("@IN@")
x, w, x1, xr, xm, wm = (f[k] for k in ("x", "w", "x1", "xr", "xm", "wm"))
mesh = jax.make_mesh((4,), ("m",), axis_types=(jax.sharding.AxisType.Auto,))

def run(fn, in_specs, out_specs, *args):
    return np.asarray(jax.device_get(shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)(*args)))

out = {
    "ag": run(lambda a: pc.ring_all_gather(a, "m", axis=0),
              P("m", None), P("m", None), x),
    "ag_axis1": run(lambda a: pc.ring_all_gather(a, "m", axis=1),
                    P(None, "m"), P(None, "m"), x1),
    "rs": run(lambda a: pc.ring_reduce_scatter(a[0], "m", axis=0),
              P("m", None, None), P("m", None), xr),
    "mm_ag": run(lambda a, b: pc.overlapped_matmul_ag(a, b, "m"),
                 (P("m", None), P(None, None)), P("m", None), x, w),
    "mm_rs": run(lambda a, b: pc.overlapped_matmul_rs(a, b, "m"),
                 (P(None, "m"), P("m", None)), P("m", None), xm, wm),
}
errors = []
for fn, args, specs in (
        (lambda a: pc.ring_reduce_scatter(a[0][:7], "m", axis=0), (xr,),
         (P("m", None, None),)),
        (lambda a, b: pc.overlapped_matmul_rs(a[:7], b, "m"), (xm, wm),
         (P(None, "m"), P("m", None)))):
    try:
        run(fn, specs if len(specs) > 1 else specs[0], P("m", None), *args)
        errors.append("")
    except ValueError as e:
        errors.append(str(e))
np.savez("@OUT@", errors=np.array(errors), **out)
print("ok")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(20)
    f32 = np.float32
    return {"x": rng.standard_normal((32, 6)).astype(f32),
            "w": rng.standard_normal((6, 10)).astype(f32),
            "x1": rng.standard_normal((6, 12)).astype(f32),
            "xr": rng.standard_normal((WORLD, 16, 5)).astype(f32),
            "xm": rng.standard_normal((16, 24)).astype(f32),
            "wm": rng.standard_normal((24, 10)).astype(f32)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    ranks = spawn_ranks("collectives", inputs, tmp)
    code = (_JAX_CODE.replace("@IN@", str(tmp / "inputs.npz"))
            .replace("@OUT@", str(tmp / "jax.npz")))
    assert "ok" in run_in_subprocess(code, n_devices=WORLD)
    with np.load(tmp / "jax.npz") as f:
        ref = {k: f[k] for k in f.files}
    return inputs, ranks, ref


CASES = ["ag", "ag_axis1", "rs", "mm_ag", "mm_rs"]


def _jax_shard(ref: dict, case: str, r: int) -> np.ndarray:
    """Device r's output of the reference (its block of out_specs)."""
    y = ref[case]
    if case == "ag_axis1":
        n = y.shape[1] // WORLD
        return y[:, r * n:(r + 1) * n]
    n = y.shape[0] // WORLD
    return y[r * n:(r + 1) * n]


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", CASES)
def test_ring_matches_reference_on_4_ranks(results, case, rank):
    _, ranks, ref = results
    got = ranks[rank][f"ring4/{case}"]
    want = _jax_shard(ref, case, rank)
    assert got.shape == want.shape and got.dtype == want.dtype
    if case.startswith("ag"):
        np.testing.assert_array_equal(got, want)  # a gather is exact
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_ring_makes_n_minus_1_hops(results, case):
    _, ranks, _ = results
    assert [r[f"ring4/{case}/hops"] for r in ranks] == [WORLD - 1] * WORLD
    assert [r[f"ring2/{case}/hops"] for r in ranks] == [1] * WORLD


@pytest.mark.parametrize("case", ["rs_error", "mm_rs_error"])
def test_indivisible_dim_raises_the_reference_error(results, case):
    _, ranks, ref = results
    want = str(ref["errors"][["rs_error", "mm_rs_error"].index(case)])
    assert want and "not divisible" in want
    assert [r[f"ring4/{case}"] for r in ranks] == [want] * WORLD
    # 7 rows do not divide over 2 either
    assert all(re.search(r"not divisible by (axis size )?2$",
                         r[f"ring2/{case}"]) for r in ranks)


@pytest.mark.parametrize("case", CASES)
def test_ring_of_2_on_the_model_dim_of_a_2x2_mesh(results, case):
    """Groups {0, 1} and {2, 3}: neighbours are mapped to global ranks."""
    inputs, ranks, _ = results
    x, w = inputs["x"], inputs["w"]
    for rank, res in enumerate(ranks):
        r, group = res["ring2/group_rank"], (rank // 2) * 2 + np.arange(2)
        assert r == rank % 2
        got = res[f"ring2/{case}"]
        if case == "ag":
            np.testing.assert_array_equal(got, x)
        elif case == "ag_axis1":
            np.testing.assert_array_equal(got, inputs["x1"])
        elif case == "rs":
            full = inputs["xr"][group].sum(0)
            np.testing.assert_allclose(got, full[r * 8:(r + 1) * 8],
                                       rtol=RTOL, atol=1e-6)
        elif case == "mm_ag":
            np.testing.assert_allclose(got, x @ w, rtol=RTOL, atol=1e-5)
        else:
            full = inputs["xm"] @ inputs["wm"]
            np.testing.assert_allclose(got, full[r * 8:(r + 1) * 8],
                                       rtol=RTOL, atol=1e-5)
