"""K12 ``bsdf_eval`` and K13 ``bsdf_sample`` (csrc/bsdf.cu) and the rules
they reproduce.

On the CPU (counted in tier-1): the plain path's selection rules, which the
kernels take from ``mat_types`` alone (``bsdf._lane_rule``): a single-type
``evaluate`` ignores ``mtype``, absent types give zeros, delta types
evaluate to zero, a single-type ``sample`` runs that type on every lane; the
rules against the plain selection for every set of types; CPU tensors never
reach a launcher; the planes the wrappers hand a launcher; each launcher's
argtypes against its ``extern "C"`` signature in the source.

On the card (``card`` marker; they skip without CUDA): both kernels against
the plain functions on the card, bit for bit, on seeded planes with grazing,
back-facing and ``wo.z == 0`` lanes and lanes whose ``mtype`` is absent from
``mat_types``; a captured CUDA graph's replay against the eager call; and
the launches of one 1080p depth-4 ``render_frame`` of data/oracle_mat.xml.
Run them on the card with
``python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_bsdf_kernel.py``
(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
lacks; this file imports none of it).
"""

import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.render import bsdf
from pupiloptixlab_tpu_torch.render.vec import Vec3

REPO = Path(__file__).resolve().parent.parent
CU = REPO / "pupiloptixlab_tpu_torch" / "csrc" / "bsdf.cu"
ORACLE_MAT = REPO / "data" / "oracle_mat.xml"

EVAL_TYPES = (bsdf.DIFFUSE, bsdf.ROUGH_DIELECTRIC, bsdf.ROUGH_CONDUCTOR, bsdf.PLASTIC,
              bsdf.ROUGH_PLASTIC)
DELTA_TYPES = (bsdf.DIELECTRIC, bsdf.CONDUCTOR)
# mat_types of the card comparisons: each type alone, all seven, the scenes'
# sets, a set without an eval, and a repeated type
CARD_SETS = [(t,) for t in bsdf.ALL_TYPES] + [
    bsdf.ALL_TYPES, (1, 5), (2, 4), (1, 2, 6), (7, 3, 5), (5, 5)]


# --- seeded inputs ---------------------------------------------------------------

def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _special_directions(n):
    """Lanes the random sphere misses: wo.z == 0, grazing and back-facing
    directions, the pole (ggx.sample's degenerate frame), wi == -wo."""
    s = np.array([
        [1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [0.0, -1.0, 0.0],
        [1.0, 0.0, 1e-7], [1.0, 0.0, -1e-7], [0.7, 0.7, 1e-5], [0.3, 0.1, -1e-3],
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1e-4, 0.0, 1.0], [0.3, -0.2, -0.9],
    ])
    s = s / np.linalg.norm(s, axis=1, keepdims=True)
    return np.resize(s, (n, 3))


def lane_inputs(n, seed, device):
    """A LocalBsdf of ``n`` lanes, wo, wi and three uniforms, from ``seed``:
    mtype over 0..8 (0 and 8 are no type), every field in the range a scene
    gives it, a tenth of the lanes from ``_special_directions``."""
    rng = np.random.default_rng(seed)

    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    def uni(lo, hi):
        return plane(rng.uniform(lo, hi, n))

    def vec(lo, hi):
        return Vec3(uni(lo, hi), uni(lo, hi), uni(lo, hi))

    wo, wi = _unit(rng, n), _unit(rng, n)
    k = n // 10
    wo[:k] = _special_directions(k)
    wi[:k] = -wo[:k]
    wi[k:2 * k] = _special_directions(k)[::-1]
    wi[2 * k:3 * k] = wo[2 * k:3 * k] * np.array([-1.0, -1.0, 1.0])  # the mirror
    alpha = rng.uniform(0.01, 1.0, n)
    alpha_v = np.where(rng.random(n) < 0.3, rng.uniform(0.01, 1.0, n), alpha)
    b = bsdf.LocalBsdf(
        mtype=torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).to(device),
        twosided=torch.from_numpy(rng.random(n) < 0.5).to(device),
        reflectance=vec(0.0, 1.0),
        specular=vec(0.0, 1.0),
        transmittance=vec(0.0, 1.0),
        eta3=vec(0.1, 3.0),
        k3=vec(0.5, 5.0),
        alpha=plane(alpha),
        alpha_v=plane(alpha_v),
        eta=plane(np.where(rng.random(n) < 0.2, rng.uniform(0.4, 1.0, n),
                           rng.uniform(1.0, 2.5, n))),
        int_fdr=uni(0.0, 0.7),
        ssw=uni(0.0, 1.0),
        nonlinear=torch.from_numpy(rng.random(n) < 0.5).to(device),
        dispersion=uni(0.0, 0.01),
    )
    u = rng.random((3, n))
    u[:, :8] = [[0.0] * 8, [0.0, 0.5, 0.99999994, 0.0, 0.25, 0.75, 1e-7, 0.5],
                [0.0, 0.0, 0.5, 0.99999994, 0.5, 0.5, 0.5, 1e-7]]
    return (b, Vec3(*(plane(wo[:, j]) for j in range(3))),
            Vec3(*(plane(wi[:, j]) for j in range(3))), tuple(plane(x) for x in u))


def same_bits(a, b):
    """Lanes where two float planes differ: by bit pattern (so -0.0 is not
    0.0), NaN against NaN counted equal."""
    if a.dtype == torch.float32:
        off = (a.view(torch.int32) != b.view(torch.int32)) & ~(a.isnan() & b.isnan())
    else:
        off = a != b
    return int(off.sum())


def _flat(res):
    return [p for r in res for p in (r if isinstance(r, Vec3) else (r,))]


def zero_lanes(vals, sel):
    return all(int((v[sel] != 0).sum()) == 0 for v in vals)


# --- CPU: the selection rules of the plain path ------------------------------------

def test_single_type_evaluate_ignores_mtype():
    b, wo, wi, _ = lane_inputs(2048, 1, "cpu")
    for t in EVAL_TYPES:
        f, pdf = bsdf.evaluate(b, wo, wi, (t,))
        ft, pt = bsdf._EVAL_FNS[t](b, wo, wi)
        other = b.mtype != t
        assert torch.equal(pdf, pt) and all(torch.equal(x, y) for x, y in zip(f, ft))
        assert int((pdf[other] > 0).sum()) > 100  # lanes of other types were evaluated
        assert bsdf._lane_rule("eval", (t,)) == (t, 1 << t)


def test_absent_and_delta_types_evaluate_to_zero():
    b, wo, wi, _ = lane_inputs(2048, 2, "cpu")
    for types in (bsdf.ALL_TYPES, (1, 5), (2, 4), (2,), (1, 2)):
        f, pdf = bsdf.evaluate(b, wo, wi, types)
        evaluated = torch.zeros_like(b.mtype, dtype=torch.bool)
        for t in types:
            if t in bsdf._EVAL_FNS:
                sel = b.mtype == t
                evaluated |= sel
                ft, pt = bsdf._EVAL_FNS[t](b, wo, wi)
                assert torch.equal(pdf[sel], pt[sel])
                assert all(torch.equal(x[sel], y[sel]) for x, y in zip(f, ft))
        assert zero_lanes((*f, pdf), ~evaluated)
        for t in DELTA_TYPES:
            assert zero_lanes((*f, pdf), b.mtype == t)
    assert bsdf._lane_rule("eval", (2, 4)) == (0, 0)
    assert bsdf._lane_rule("eval", (1, 2)) == (0, 1 << 1)


def test_single_type_sample_runs_on_every_lane():
    b, wo, _, (u0, u1, u2) = lane_inputs(2048, 3, "cpu")
    for t in bsdf.ALL_TYPES:
        got = bsdf.sample(b, wo, u0, u1, u2, (t,))
        want = bsdf._SAMPLE_FNS[t](b, wo, u0, u1, u2)
        assert all(torch.equal(x, y) for g, w in zip(got[:2], want[:2]) for x, y in zip(g, w))
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        assert bool((got[3] != 0).all())  # every lane, whatever its mtype, has a lobe
        assert bsdf._lane_rule("sample", (t,)) == (t, 1 << t)


def test_absent_types_sample_to_zero():
    b, wo, _, (u0, u1, u2) = lane_inputs(2048, 4, "cpu")
    for types in ((1, 5), (2, 4, 6), bsdf.ALL_TYPES):
        wi, f, pdf, lobe = bsdf.sample(b, wo, u0, u1, u2, types)
        absent = ~torch.isin(b.mtype, torch.tensor(types, dtype=torch.int32))
        assert int(absent.sum()) > 0
        assert zero_lanes((*wi, *f, pdf, lobe), absent)
        assert bool((lobe[~absent] != 0).all())


def _kernel_model(b, lanes, mat_types, kind):
    """What the kernels compute, in plain PyTorch: each lane's type from
    the rule of ``mat_types`` (force, or mtype if its bit is in the mask),
    that type's plain function, zeros elsewhere."""
    force, mask = bsdf._lane_rule(kind, mat_types)
    fns = bsdf._EVAL_FNS if kind == "eval" else bsdf._SAMPLE_FNS
    if force:
        t = torch.full_like(b.mtype, force)
    else:
        m = b.mtype
        ok = (m >= 1) & (m <= 7) & (((mask >> m.clamp(0, 30)) & 1) == 1)
        t = torch.where(ok, m, 0)
    outs = None
    for ty, fn in fns.items():
        flat = _flat(fn(b, *lanes))
        if outs is None:
            outs = [torch.zeros_like(p) for p in flat]
        sel = t == ty
        outs = [torch.where(sel, p, o) for p, o in zip(flat, outs)]
    return outs


def test_rules_reproduce_the_plain_selection_for_every_set_of_types():
    b, wo, wi, us = lane_inputs(1024, 5, "cpu")
    sets = [c for k in range(1, 8) for c in itertools.combinations(bsdf.ALL_TYPES, k)]
    sets += [(5, 5), (7, 1), (2, 2), (3, 6, 3)]
    for types in sets:
        plain = _flat(bsdf.evaluate_plain(b, wo, wi, types))
        model = _kernel_model(b, (wo, wi), types, "eval")
        assert all(same_bits(p, m) == 0 for p, m in zip(plain, model)), ("eval", types)
        plain = _flat(bsdf.sample_plain(b, wo, *us, types))
        model = _kernel_model(b, (wo, *us), types, "sample")
        assert all(same_bits(p, m) == 0 for p, m in zip(plain, model)), ("sample", types)


def test_cpu_tensors_never_reach_a_launcher(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU call reached the launcher of {name}")

    monkeypatch.setattr(kernels, "launcher", refuse)
    before = dict(kernels.LAUNCHES)
    b, wo, wi, us = lane_inputs(256, 6, "cpu")
    for types in (bsdf.ALL_TYPES, (1,), (1, 5)):
        bsdf.evaluate(b, wo, wi, types)
        bsdf.sample(b, wo, *us, types)
    assert kernels.LAUNCHES == before


def test_launch_planes_checks_every_plane():
    """What the wrappers hand the launcher (``bsdf._launch_planes``, run here
    on CPU tensors): 28 pointers in the launcher's order, a strided plane
    copied to a contiguous one, and a plane of another dtype or length
    refused before any pointer is passed."""
    b, wo, wi, _ = lane_inputs(64, 7, "cpu")
    ptrs, held, n, _ = bsdf._launch_planes("bsdf_eval", b, (*wo, *wi))
    assert n == 64 and len(ptrs) == len(held) == 28
    assert ptrs[0] == b.mtype.data_ptr() and ptrs[-1] == wi.z.data_ptr()
    strided = torch.stack([wo.x, wo.x], dim=1)[:, 0]
    ptrs, held, _, _ = bsdf._launch_planes("bsdf_eval", b, (strided, wo.y, wo.z, *wi))
    assert held[22].is_contiguous() and torch.equal(held[22], wo.x)
    for bad in (dict(alpha=b.alpha.double()), dict(mtype=b.mtype.long()),
                dict(nonlinear=b.nonlinear.float()), dict(eta=b.eta[:32])):
        with pytest.raises(ValueError, match="bsdf_eval: plane"):
            bsdf._launch_planes("bsdf_eval", dataclasses.replace(b, **bad), (*wo, *wi))


@pytest.mark.parametrize("name", ["bsdf_eval", "bsdf_sample"])
def test_launcher_argtypes_match_the_source(name):
    stem, sym, argtypes = kernels.KERNELS[name]
    assert stem == "bsdf"
    src = CU.read_text()
    m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", src)
    assert m, sym
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    for p, a in zip(params, argtypes):
        is_ptr = "*" in p or p.startswith("cudaStream_t")
        assert is_ptr == (a is kernels._P), (p, a)
        assert is_ptr or (p.startswith("int ") and a is kernels._I), (p, a)


# --- on the card ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA): the kernels run only there")
    kernels.build_all()
    return torch.device("cuda")


def _assert_bit_equal(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    off = [same_bits(g, w) for g, w in zip(got, want)]
    assert all(o == 0 for o in off), f"{what}: lanes off per output {off}"
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g[~w.isnan()], w[~w.isnan()])


@pytest.mark.card
@pytest.mark.parametrize("types", CARD_SETS)
def test_k12_equals_plain_on_the_card(card, types):
    b, wo, wi, _ = lane_inputs(1 << 18, 11, card)
    before = kernels.LAUNCHES["bsdf_eval"]
    got = bsdf.evaluate(b, wo, wi, types)
    assert kernels.LAUNCHES["bsdf_eval"] == before + 1
    _assert_bit_equal(got, bsdf.evaluate_plain(b, wo, wi, types), f"bsdf_eval {types}")


@pytest.mark.card
@pytest.mark.parametrize("types", CARD_SETS)
def test_k13_equals_plain_on_the_card(card, types):
    b, wo, _, us = lane_inputs(1 << 18, 12, card)
    before = kernels.LAUNCHES["bsdf_sample"]
    got = bsdf.sample(b, wo, *us, types)
    assert kernels.LAUNCHES["bsdf_sample"] == before + 1
    want = bsdf.sample_plain(b, wo, *us, types)
    _assert_bit_equal(got, want, f"bsdf_sample {types}")


@pytest.mark.card
def test_graph_replay_equals_the_eager_call(card):
    b, wo, wi, us = lane_inputs(1 << 16, 13, card)
    eager = (bsdf.evaluate(b, wo, wi), bsdf.sample(b, wo, *us))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bsdf.evaluate(b, wo, wi)
        bsdf.sample(b, wo, *us)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.captured_launches() as per_replay, torch.cuda.graph(graph):
        cap = (bsdf.evaluate(b, wo, wi), bsdf.sample(b, wo, *us))
    assert per_replay == {"bsdf_eval": 1, "bsdf_sample": 1}
    for res in cap:
        for p in _flat(res):
            p.fill_(7)
    graph.replay()
    torch.cuda.synchronize()
    _assert_bit_equal(cap[0], eager[0], "bsdf_eval replayed")
    _assert_bit_equal(cap[1], eager[1], "bsdf_sample replayed")


@pytest.mark.card
def test_a_1080p_frame_launches_each_kernel_once_a_bounce(card):
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.scene import load_scene

    scene = load_scene(ORACLE_MAT)
    scene.sensor.film.w, scene.sensor.film.h = 1920, 1080
    data, config = flatten_scene(scene, device=card)
    cam = camera_block_from_scene(scene, device=card)
    assert config.max_depth == 4 and set(config.mat_types) == set(bsdf.ALL_TYPES)
    accum = torch.zeros((1920 * 1080, 3), dtype=torch.float32, device=card)
    kernels.reset_launches()
    _, bufs = render_frame(data, cam, 0, 0, accum, config)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bsdf_eval"] == 3 and kernels.LAUNCHES["bsdf_sample"] == 3
    assert bool(torch.isfinite(bufs["frame"]).all())
