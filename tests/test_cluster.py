"""Cluster (meshlet) intersector vs the brute-force oracle.

The cluster path (``ops/cluster_pallas.py`` + ``accel/clusters.py``) is the
large-scene GPU intersector — XLA AABB cull + per-row Triton visit kernel.
These tests run the kernel in the Pallas interpreter on CPU and validate:

- builder invariants (partition of triangles, bounding boxes bound members);
- closest/any-hit exactness vs the oracle, including the Lmax-overflow
  residual sweep, ray counts off the ray block, and the lowest-original-id
  tie-break, for several ray blocks and cluster sizes;
- that the kernels lower to Triton for CUDA (no card needed to lower);
- end-to-end render parity with the brute-force integrator;
- custom-VJP gradient parity.
tests/test_gpu.py runs the compiled kernel on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chiaroscuro_tpu.accel.clusters import build_clusters
from chiaroscuro_tpu.geometry.intersect import (
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu.ops.cluster_pallas import make_cluster_intersectors
from chiaroscuro_tpu.scene.builtin import cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.obj_loader import Mesh


def _random_soup(rng, T, spread=4.0, size=0.6):
    base = rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    v0 = base
    v1 = base + rng.normal(scale=size, size=(T, 3)).astype(np.float32)
    v2 = base + rng.normal(scale=size, size=(T, 3)).astype(np.float32)
    return v0, v1, v2


def _soup_scene(v0, v1, v2):
    """Wrap a raw triangle soup as a one-mesh scene."""
    T = len(v0)
    verts = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    mesh = Mesh(
        name="soup",
        positions=verts.astype(np.float32),
        normals=np.zeros_like(verts),
        uvs=np.zeros((3 * T, 2), np.float32),
        indices=np.arange(3 * T, dtype=np.int32).reshape(-1, 3),
        diffuse=np.array([0.5, 0.5, 0.5], np.float32),
        emissive=np.zeros(3, np.float32),
        ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32),
        shininess=0.0,
    )
    return build_scene_arrays([mesh])


def _rays(rng, n, lo, hi):
    ext = hi - lo
    o = rng.uniform(lo - 0.1 * ext, hi + 0.1 * ext, (n, 3))
    d = rng.normal(size=(n, 3))
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_builder_partitions_triangles(rng):
    v0, v1, v2 = _random_soup(rng, 333)
    ca = build_clusters(v0, v1, v2, M=16)
    # Every triangle appears exactly once across clusters.
    np.testing.assert_array_equal(np.sort(ca.order), np.arange(333))
    real = ca.orig_id[ca.orig_id < 333]
    np.testing.assert_array_equal(np.sort(real), np.arange(333))
    # pack=True re-chunks the DFS order into full clusters: K is exactly
    # ceil(T / M) and every cluster but the last is fully occupied.
    assert ca.K == -(-333 // 16)
    occ = np.array([(ca.orig_id[k * 16:(k + 1) * 16] < 333).sum()
                    for k in range(ca.K)])
    assert (occ[:-1] == 16).all() and occ[-1] == 333 - 16 * (ca.K - 1)
    # pack=False keeps one cluster per median-split leaf: the exact-median
    # split guarantees every leaf holds > M/2 triangles.
    cu = build_clusters(v0, v1, v2, M=16, pack=False)
    occ_u = np.array([(cu.orig_id[k * 16:(k + 1) * 16] < 333).sum()
                      for k in range(cu.K)])
    assert (occ_u > 16 // 2).all()
    # Boxes bound their members (with padding).
    for k in range(ca.K):
        sl = slice(k * ca.M, (k + 1) * ca.M)
        ids = ca.orig_id[sl][ca.orig_id[sl] < 333]
        pts = np.concatenate([v0[ids], v1[ids], v2[ids]])
        assert (pts >= ca.bbox_min[k] - 1e-6).all()
        assert (pts <= ca.bbox_max[k] + 1e-6).all()


@pytest.mark.parametrize(
    "lmax,ray_block,M",
    [(4, 128, 16), (64, 128, 16), (64, 32, 32), (4, 64, 16)],
)
def test_cluster_closest_matches_oracle(rng, lmax, ray_block, M):
    """lmax=4 forces frequent overflow (phase-2 residual sweeps); lmax=64
    makes every row fit its candidate list; smaller ray blocks give each
    kernel program fewer rays and a tighter list.  All must be exact."""
    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    cf, _ = make_cluster_intersectors(
        scene, M=M, Lmax=lmax, interpret=True, ray_block=ray_block,
    )
    o, d = _rays(rng, 300, np.float32(-4.4), np.float32(4.4))
    ph, pt, ptid, pu, pv = cf(o, d)[:5]
    oh, ot, otid, ou, ov = intersect_closest_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2
    )
    np.testing.assert_array_equal(np.asarray(ph), np.asarray(oh))
    hit = np.asarray(oh)
    np.testing.assert_allclose(
        np.asarray(pt)[hit], np.asarray(ot)[hit], rtol=1e-5
    )
    same = np.asarray(ptid)[hit] == np.asarray(otid)[hit]
    ties = np.isclose(np.asarray(pt)[hit], np.asarray(ot)[hit], rtol=1e-6)
    assert (same | ties).all()
    np.testing.assert_allclose(
        np.asarray(pu)[hit][same], np.asarray(ou)[hit][same], rtol=1e-4,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(pv)[hit][same], np.asarray(ov)[hit][same], rtol=1e-4,
        atol=1e-5,
    )


@pytest.mark.parametrize("ray_block", [128, 32])
def test_cluster_any_matches_oracle(rng, ray_block):
    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    _, af = make_cluster_intersectors(
        scene, M=16, Lmax=8, interpret=True, ray_block=ray_block
    )
    o, d = _rays(rng, 300, np.float32(-4.4), np.float32(4.4))
    tmax = jnp.asarray(rng.uniform(0.5, 10.0, (300,)), jnp.float32)
    excl = jnp.asarray(rng.integers(0, 300, (300,)), jnp.int32)
    occ = af(o, d, tmax, excl)
    ref = intersect_any_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, tmax, excl
    )
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_cluster_attrs_match_scene_gathers(rng):
    scene = build_scene_arrays(cornell_box())
    cf, _ = make_cluster_intersectors(scene, M=8, Lmax=16, interpret=True)
    lo = np.asarray(scene.world_min)
    hi = np.asarray(scene.world_max)
    o, d = _rays(rng, 200, lo, hi)
    res = cf(o, d)
    hit = np.asarray(res.hit)
    tid = np.asarray(res.tid)[hit]
    A = {k: np.asarray(v)[hit] for k, v in res.attrs.items()}
    np.testing.assert_allclose(A["v0"], np.asarray(scene.tri_v0)[tid], rtol=1e-6)
    np.testing.assert_allclose(A["normal"], np.asarray(scene.normal)[tid], atol=1e-6)
    np.testing.assert_allclose(A["kd"], np.asarray(scene.kd)[tid], rtol=1e-6)
    np.testing.assert_allclose(A["ke"], np.asarray(scene.ke)[tid], rtol=1e-6)
    np.testing.assert_array_equal(A["btype"], np.asarray(scene.brdf_type)[tid])
    np.testing.assert_array_equal(A["texid"], np.asarray(scene.tex_id)[tid])


def test_cluster_render_matches_brute():
    from chiaroscuro_tpu.accel.dispatch import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA as cam

    scene = build_scene_arrays(cornell_box())
    eye = jnp.asarray(cam["eye"], jnp.float32)
    center = jnp.asarray(cam["center"], jnp.float32)
    up = jnp.asarray(cam["up"], jnp.float32)
    xres = yres = 24
    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32), np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    px = jnp.asarray(xs.reshape(-1))
    py = jnp.asarray(ys.reshape(-1))

    def render(cf, af):
        return render_samples(
            scene, eye, center, up, jnp.float32(cam["yview"]), xres, yres,
            px, py, jnp.int32(0), 2, jnp.uint32(7), 3,
            jnp.zeros(3, jnp.float32), cf, af,
        )

    cf, af = make_cluster_intersectors(scene, M=8, Lmax=8, interpret=True)
    img_cluster = np.asarray(render(cf, af))
    bf, ba = make_intersectors(scene, "brute")
    img_brute = np.asarray(render(bf, ba))
    np.testing.assert_allclose(img_cluster, img_brute, rtol=1e-4, atol=1e-5)


def test_cluster_gradients_match_bruteforce():
    from chiaroscuro_tpu.accel.dispatch import make_intersectors
    from chiaroscuro_tpu.render.renderer import render_samples

    scene = build_scene_arrays(cornell_box())
    eye = jnp.asarray([0.0, 1.0, 3.2], jnp.float32)
    center = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    xres = yres = 16
    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32), np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    px = jnp.asarray(xs.reshape(-1))
    py = jnp.asarray(ys.reshape(-1))

    def make_loss(method):
        def loss(params):
            s = dataclasses.replace(scene, **params)
            if method == "cluster":
                cf, af = make_cluster_intersectors(
                    s, M=8, Lmax=8, interpret=True,
                    clusters=build_clusters(
                        np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                        np.asarray(scene.tri_v2), 8,
                    ),
                )
            else:
                cf, af = make_intersectors(s, "brute")
            img = render_samples(
                s, eye, center, up, jnp.float32(1.0), xres, yres, px, py,
                jnp.int32(0), 2, jnp.uint32(3), 3,
                jnp.zeros(3, jnp.float32), cf, af,
            )
            return jnp.mean(
                img * jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
            )
        return loss

    params = {"kd": scene.kd, "ke": scene.ke, "tri_v0": scene.tri_v0}
    g_cluster = jax.grad(make_loss("cluster"))(params)
    g_brute = jax.grad(make_loss("brute"))(params)
    for k in params:
        a, b = np.asarray(g_cluster[k]), np.asarray(g_brute[k])
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=k)


def test_cluster_grads_under_jit_scan_match_oracle(cornell_scene):
    """jit(value_and_grad) of a full render (scan over samples/bounces)
    through the cluster custom_vjp — regression for the scene-pytree-in-
    residuals lowering failure ('No constant handler for
    DynamicJaxprTracer'); grads must equal the brute-oracle path."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from chiaroscuro_tpu.accel import make_intersectors
    from chiaroscuro_tpu.accel.clusters import build_clusters
    from chiaroscuro_tpu.render.renderer import render_samples
    from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA as cam

    scene = cornell_scene
    ca = build_clusters(
        np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
        np.asarray(scene.tri_v2))
    ys, xs = np.meshgrid(np.arange(8, dtype=np.int32),
                         np.arange(16, dtype=np.int32), indexing="ij")
    px, py = jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1))

    def make_loss(intersectors_of):
        def loss(params, scene):
            s = dataclasses.replace(scene, **params)
            cf, af = intersectors_of(s)
            img = render_samples(
                s, jnp.asarray(cam["eye"], jnp.float32),
                jnp.asarray(cam["center"], jnp.float32),
                jnp.asarray(cam["up"], jnp.float32),
                jnp.float32(cam["yview"]), 16, 8, px, py,
                jnp.int32(0), 2, jnp.uint32(0), 2,
                jnp.zeros(3, jnp.float32), cf, af)
            return jnp.mean(img)
        return loss

    params = {"kd": scene.kd, "ke": scene.ke}
    lc, gc = jax.jit(jax.value_and_grad(make_loss(
        lambda s: make_cluster_intersectors(s, clusters=ca, interpret=True)
    )))(params, scene)
    lb, gb = jax.jit(jax.value_and_grad(make_loss(
        lambda s: make_intersectors(s, "brute")
    )))(params, scene)
    np.testing.assert_allclose(float(lc), float(lb), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(gc[k]), np.asarray(gb[k]), rtol=1e-4, atol=1e-7)


def test_bind_buffers_matches_bind_scene(rng):
    """The pass-buffers-as-jit-arguments path (derive_buffers +
    bind_buffers, used by multi-frame renderers/benches) must agree with
    the default bind_scene derivation (to XLA const-vs-arg codegen ulp),
    and render_samples must not re-derive through it (bind_scene is None
    on the bound fns)."""
    import jax

    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    cf, af = make_cluster_intersectors(scene, M=16, Lmax=8, interpret=True)
    o, d = _rays(rng, 256, np.float32(-4.4), np.float32(4.4))

    bufs = cf.derive_buffers(scene)
    assert all(not isinstance(b, np.ndarray) for b in bufs)  # device-resident

    @jax.jit
    def via_buffers(bufs, o, d):
        c2, a2 = cf.bind_buffers(bufs)
        assert c2.bind_scene is None and a2.bind_scene is None
        res = c2(o, d)
        occ = a2(o, d, jnp.where(res.hit, res.t * 1.5, 1e9),
                 jnp.full((256,), -1, jnp.int32))
        return res.t, res.tid, res.hit, occ

    t_b, tid_b, hit_b, occ_b = via_buffers(bufs, o, d)
    res = cf(o, d)
    occ = af(o, d, jnp.where(res.hit, res.t * 1.5, 1e9),
             jnp.full((256,), -1, jnp.int32))
    np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(res.hit))
    hit = np.asarray(res.hit)
    np.testing.assert_allclose(
        np.asarray(t_b)[hit], np.asarray(res.t)[hit], rtol=1e-6
    )
    # Ulp t-differences can flip ties; ids must agree wherever t is not
    # tie-close (same contract as the oracle comparison above).
    same = np.asarray(tid_b)[hit] == np.asarray(res.tid)[hit]
    ties = np.isclose(
        np.asarray(t_b)[hit], np.asarray(res.t)[hit], rtol=1e-6
    )
    assert (same | ties).all()
    np.testing.assert_array_equal(np.asarray(occ_b), np.asarray(occ))


def _run(scene, o, d, **kw):
    cf, af = make_cluster_intersectors(scene, interpret=True, **kw)
    res = cf(o, d)
    occ = af(o, d, jnp.where(res.hit, res.t * 1.1, 1e9),
             jnp.full((o.shape[0],), -1, jnp.int32))
    return res, occ


def _assert_bitwise(a, b):
    for f in ("hit", "t", "tid", "u", "v"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a[0], f)), np.asarray(getattr(b[0], f)),
            err_msg=f)
    for k in a[0].attrs:
        np.testing.assert_array_equal(
            np.asarray(a[0].attrs[k]), np.asarray(b[0].attrs[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.parametrize("ray_block", [32, 64])
def test_transposed_visit_equivalent(rng, ray_block):
    """The ray block sets which rays share a candidate list and a kernel
    program, never what a ray computes: each (ray, triangle) pair runs the
    same float ops and the (t, original id) minimum does not depend on
    visit order, so results are bitwise equal to the 128-ray block.  Small
    Lmax covers overflow rows too."""
    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    o, d = _rays(rng, 256, np.float32(-4.4), np.float32(4.4))
    _assert_bitwise(_run(scene, o, d, M=16, Lmax=4),
                    _run(scene, o, d, M=16, Lmax=4, ray_block=ray_block))


@pytest.mark.parametrize("M", [32, 48, 64])
def test_visit_unroll_bitwise_identical(rng, M):
    """Cluster size M changes the meshlets (boxes, lists, visit order) but
    not the per-(ray, triangle) arithmetic or the lexicographic (t, id)
    minimum: results must be bitwise identical to M=16.  Small Lmax
    exercises the phase-2 residual sweep too."""
    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    o, d = _rays(rng, 256, np.float32(-4.4), np.float32(4.4))
    _assert_bitwise(_run(scene, o, d, M=16, Lmax=4),
                    _run(scene, o, d, M=M, Lmax=4))


def test_beam_cull_conservative_and_exact(rng):
    """The cull's per-row hit mask is a superset of every ray's own box
    hits, its entry bounds lower-bound every ray's own entry distance, and
    the dense sweep (no cull: every row visits all K clusters) matches the
    culled intersector bitwise."""
    from chiaroscuro_tpu.accel.clusters import build_clusters
    from chiaroscuro_tpu.ops.cluster_pallas import (
        _rows_to_planar, _rowhit_scan, _safe_inv,
    )

    v0, v1, v2 = _random_soup(rng, 300)
    scene = _soup_scene(v0, v1, v2)
    ca = build_clusters(v0, v1, v2, M=16)
    o, d = _rays(rng, 256, np.float32(-4.4), np.float32(4.4))
    o3, _ = _rows_to_planar(o)
    d3, _ = _rows_to_planar(d)
    row_hit, row_entry = map(np.asarray, _rowhit_scan(
        o3, _safe_inv(d3), ca.bbox_min, ca.bbox_max))
    # Per-ray reference: rows of one ray each.
    ray_hit, ray_entry = map(np.asarray, _rowhit_scan(
        o3.reshape(3, -1, 1), _safe_inv(d3.reshape(3, -1, 1)),
        ca.bbox_min, ca.bbox_max))
    ray_hit = ray_hit.reshape(-1, 128, ca.K)
    ray_entry = ray_entry.reshape(-1, 128, ca.K)
    assert (row_hit | ~ray_hit.any(axis=1)).all()        # superset
    assert (row_entry[:, None, :] <= ray_entry + 1e-6)[ray_hit].all()
    _assert_bitwise(_run(scene, o, d, M=16, Lmax=8),
                    _run(scene, o, d, M=16, Lmax=8, cull=False))


def test_overflow_runs_residual_sweep_exactly(rng):
    """With a candidate list narrower than the rows' box counts, rows
    overflow: phase 1 walks the Le nearest boxes and the phase-2 residual
    sweep must still find every exact hit."""
    from chiaroscuro_tpu.accel.clusters import build_clusters
    from chiaroscuro_tpu.ops.cluster_pallas import _cull_rows, _rows_to_planar

    v0, v1, v2 = _random_soup(rng, 600, spread=2.0)
    scene = _soup_scene(v0, v1, v2)
    ca = build_clusters(v0, v1, v2, M=16)
    o, d = _rays(rng, 384, np.float32(-2.2), np.float32(2.2))
    o3, _ = _rows_to_planar(o)
    d3, _ = _rows_to_planar(d)
    meta, ids, nears, cutoff = map(np.asarray, _cull_rows(
        o3, d3, ca.bbox_min, ca.bbox_max, Lmax=2))
    over = meta[:, 1] == 1
    assert over.any()
    assert (meta[over, 0] == 2).all() and np.isfinite(cutoff[over]).all()
    assert np.isinf(cutoff[~over]).all()
    assert (np.diff(nears, axis=1) >= 0).all()          # near-ascending
    res, occ = _run(scene, o, d, clusters=ca, Lmax=2)
    oh, ot, otid, _, _ = intersect_closest_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2)
    np.testing.assert_array_equal(np.asarray(res.hit), np.asarray(oh))
    hit = np.asarray(oh)
    np.testing.assert_allclose(np.asarray(res.t)[hit], np.asarray(ot)[hit],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(occ), hit)


@pytest.mark.parametrize("n_rays,ray_block", [(300, 32), (1000, 64)])
def test_ray_counts_off_the_block_pad(rng, n_rays, ray_block):
    """Ray counts that are not a multiple of 128 (or of the ray block) pad
    with replicas of ray 0; the padding is sliced off and every real ray
    matches the oracle."""
    v0, v1, v2 = _random_soup(rng, 200)
    scene = _soup_scene(v0, v1, v2)
    o, d = _rays(rng, n_rays, np.float32(-4.4), np.float32(4.4))
    res, _ = _run(scene, o, d, M=16, Lmax=8, ray_block=ray_block)
    assert res.t.shape == (n_rays,) and res.attrs["normal"].shape == (
        n_rays, 3)
    oh, ot, otid, _, _ = intersect_closest_bruteforce(
        o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2)
    np.testing.assert_array_equal(np.asarray(res.hit), np.asarray(oh))
    hit = np.asarray(oh)
    np.testing.assert_array_equal(np.asarray(res.tid)[hit],
                                  np.asarray(otid)[hit])


@pytest.mark.parametrize("cull", [True, False])
def test_kernels_lower_to_triton_for_cuda(cull):
    """Both visit kernels lower to Triton IR for a CUDA target — the step
    that runs in Python and needs no card (compiling that IR to a cubin
    happens on the card; tests/test_gpu.py covers it)."""
    from chiaroscuro_tpu.ops import cluster_pallas as cp

    NR, RB, K, M, Le = 16, 128, 8, 32, 8
    sds = jax.ShapeDtypeStruct
    lists = (sds((NR, 2), jnp.int32), sds((NR, Le), jnp.int32),
             sds((NR, Le), jnp.float32), sds((NR, 1), jnp.float32)) \
        if cull else ()
    ray = sds((3, NR, RB), jnp.float32)
    row = sds((NR, RB), jnp.float32)
    geo = sds((cp.GEO_W, K * M), jnp.float32)
    checks = [jax.export.DisabledSafetyCheck.custom_call(
        "__gpu$xla.gpu.triton")]

    def export(f, *args):
        return jax.export.export(jax.jit(f), platforms=["cuda"],
                                 disabled_checks=checks)(*args).mlir_module()

    shape = (M, Le, cp.SUB, cp.NUM_WARPS)
    closest = export(lambda l, o, d, g: cp._closest_call(l, o, d, g, *shape),
                     lists, ray, ray, geo)
    any_ = export(
        lambda l, o, d, t, e, g: cp._any_call(l, o, d, t, e, g, *shape),
        lists, ray, ray, row, row, geo)
    for mod in (closest, any_):
        assert "__gpu$xla.gpu.triton" in mod
