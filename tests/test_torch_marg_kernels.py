"""The plain versions of K5 (the dense Schur step) and K11 (the
marginalization prior) against ba_tpu, and the kernels' algorithms
against the plain versions, on the CPU in f64.

  * K5's plain version (`schur_finish_plain`) equals ba_tpu's `finish` on
    the same contribution (S, rhs with the column mask) at pose_dim 9 and
    15 and landmark sizes 1 and 3, to 1e-9 relative: the same operations.
  * `window.marginalize` (K5's plain version cut to the pose rows, then
    K11's) equals ba_tpu's at pose_dim 15 with XYZ landmarks (lm 3) and
    two departing poses, to 1e-9 (the sums of the build in another order,
    then an inverse and an eigendecomposition); tests/test_torch_window.py
    holds pose_dim 9, inverse depth and one departing pose.
  * K11 (a): the departing block inverted alone, (S_dd + eps I)^-1, is the
    d-block of ba_tpu's masked inverse, and the prior it gives equals the
    masked-inverse prior, to 1e-12 relative.
  * K11 (b2): a torch walk of the kernel's Jacobi method (the same
    round-robin pairs over the active dims, rotation threshold and stop
    test, H minus the negative eigenvalues' part) equals the `eigh` clip
    to 1e-10 of ||H|| on inputs with clipped negative eigenvalues,
    converges within a few sweeps, and leaves a PSD input unchanged to
    1e-14.
  * K11 (b1): a torch walk of the kernel's certificate (the shifted f64
    Cholesky of the active block) certifies exactly the inputs with no
    eigenvalue below -tau: a PSD prior with a singular kept block (the
    gauge) and masked dims, one eigenvalue at -0.1 tau; not one at
    -10 tau or an indefinite prior.  Where it certifies, the unclipped H
    is within sqrt(#neg) tau of ba_tpu's `eigh` clip.
  * K5: a torch walk of the kernel's tile-mask schedule (landmark masks
    per 32 rows of W, each tile's common landmarks in ascending order,
    split or not across a cluster's blocks) equals the dense ordered walk
    bit for bit when unsplit, and schur_finish_plain and ba_tpu's finish
    to 1e-12 (lm 1 and 3, an empty tile pair, the column mask, n < N,
    K = 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import window as jwin
from ba_tpu_torch.kernels import marginalize as k11
from ba_tpu_torch.kernels import schur_finish as k5
from ba_tpu_torch.solver import window as twin
from ba_tpu_torch.utils.linalg import block_diag_inv

import chip_smoke
from test_torch_common import assert_rel, to_torch, torch_config

TOL = 1e-9


def _contribution(P, D, L, lm, seed):
    """A random contribution (U symmetric, W sparse, V SPD blocks) of P
    poses of width D and L landmarks of size lm, and a column mask."""
    rng = np.random.default_rng(seed)
    N = P * D
    U = rng.standard_normal((N, N))
    W = rng.standard_normal((N, L * lm)) * (rng.random((N, L * lm)) < 0.2)
    Vb = rng.standard_normal((L, lm, lm))
    V = Vb @ np.swapaxes(Vb, 1, 2) + np.eye(lm)
    cmask = rng.random(N) > 0.1
    return dict(U=U + U.T, rhs_p=rng.standard_normal(N), W=W, V=V,
                rhs_l=rng.standard_normal(L * lm), cost=np.zeros(())), cmask


@pytest.mark.parametrize("D,lm", [(9, 1), (9, 3), (15, 1), (15, 3)])
def test_schur_finish_plain_matches_ba_tpu_finish(D, lm):
    c, cmask = _contribution(6, D, 17, lm, D + lm)
    want = jasm.finish(jasm.Contribution(**{k: jnp.asarray(v)
                                            for k, v in c.items()}),
                       jnp.asarray(cmask), None)
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    S, rhs = k5.schur_finish_plain(t["U"], t["W"], block_diag_inv(t["V"]),
                                   t["rhs_p"], t["rhs_l"],
                                   torch.as_tensor(cmask))
    assert_rel(S, np.asarray(want.S), TOL, "S")
    assert_rel(rhs, np.asarray(want.rhs_sc), TOL, "rhs")


def _marg_case(pose_dim, lm_size):
    cfg = jprob.BAConfig(pose_dim=pose_dim, lm_size=lm_size,
                         use_dogleg=False)
    sim = jsv.simulate(n_poses=8, n_lms=32, seed=4)
    jp, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=5)
    jp = jprob.prepare_landmarks(jp, cfg)
    return jp, cfg, to_torch(jp), torch_config(cfg)


def test_marginalize_prior_matches_ba_tpu():
    drop = (1, 2)
    jp, jcfg, tp, tcfg = _marg_case(15, 3)
    d = np.isin(np.arange(tp.poses.q.shape[0]), drop)
    want = jwin.marginalize(jp, jcfg, True, jnp.asarray(d))
    got = twin.marginalize(tp, tcfg, True, torch.as_tensor(d))
    for f in dataclasses.fields(want):
        assert_rel(getattr(got, f.name), getattr(want, f.name), TOL, f.name)


def _indefinite(n, drop, seed):
    """(S, rhs, pd): a symmetric system whose Schur complement keeps
    negative eigenvalues."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 5))
    v = rng.standard_normal((n, 3))
    S = (A @ A.T - 3.0 * v @ v.T) / n
    pd = np.zeros(n, bool)
    pd[list(drop)] = True
    return (torch.as_tensor(0.5 * (S + S.T)),
            torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(pd))


def _direct_prior(S, rhs, pd, eps):
    """K11 (a): the departing block inverted alone, symmetrized (before the
    clip); returns (H, g, X)."""
    d = torch.nonzero(pd).reshape(-1)
    X = torch.linalg.inv(S[d][:, d]
                         + eps * torch.eye(len(d), dtype=S.dtype))
    Z = S[:, d] @ X
    keep = (~pd).to(S.dtype)
    H = (S - Z @ S[:, d].T) * keep[:, None] * keep[None, :]
    g = (rhs - S[:, d] @ (X @ rhs[d])) * keep
    return 0.5 * (H + H.T), g, X


@pytest.mark.parametrize("n,drop", [(27, range(9, 18)),
                                    (45, list(range(0, 9)) + [30, 31, 44])])
def test_departing_block_inverse_is_the_masked_inverse(n, drop):
    S, rhs, pd = _indefinite(n, drop, n)
    eps = 1e-9
    H, g, X = _direct_prior(S, rhs, pd, eps)
    Pd = pd.double()
    B = (S * Pd[:, None] * Pd[None, :] + torch.diag(1.0 - Pd)
         + eps * torch.diag(Pd))
    Binv = torch.linalg.inv_ex(B).inverse
    d = torch.nonzero(pd).reshape(-1)
    assert_rel(X, Binv[d][:, d].numpy(), 1e-12, "d-block")
    # the rest of B^-1 is the identity: nothing leaks into the kept dims
    keep = torch.nonzero(~pd).reshape(-1)
    assert_rel(Binv[keep][:, keep], np.eye(len(keep)), 1e-12, "kept block")
    # the prior before the clip: the plain version's own first steps
    SP = S * Pd[None, :]
    Bm = Binv * Pd[:, None] * Pd[None, :]
    Hp = (S - SP @ Bm @ SP.T) * (1 - Pd)[:, None] * (1 - Pd)[None, :]
    assert_rel(H, (0.5 * (Hp + Hp.T)).numpy(), 1e-12, "H")
    assert_rel(g, ((rhs - SP @ (Bm @ (rhs * Pd))) * (1 - Pd)).numpy(),
               1e-12, "g")


def _round_pairs(m, r):
    """The kernel's circle schedule: round r's pairs (p < q) over m (even)
    indices."""
    def slot(i):
        return 0 if i == 0 else 1 + (i - 1 + r) % (m - 1)

    pairs = [(slot(t), slot(m - 1 - t)) for t in range(m // 2)]
    return [(min(a, b), max(a, b)) for a, b in pairs]


def jacobi_clip_walk(H, max_sweeps=k11.MAX_SWEEPS):
    """csrc/marginalize.cu (b2) in torch: cyclic Jacobi in round-robin
    order on the active dims (the rows of H not exactly zero), a pair
    rotating when |a_pq| > eps ||H||_F / n with its 2 x 2 block set
    exactly, sweeps while an off-diagonal element exceeds that; then H -
    sum over the negative eigenvalues of l v v^T.  Returns (projection,
    sweeps, rotations, converged)."""
    n = H.shape[0]
    act = torch.nonzero((H != 0).any(1)).reshape(-1)
    na = act.numel()
    A, V = H[act][:, act].clone(), torch.eye(na, dtype=H.dtype)
    delta = torch.finfo(H.dtype).eps * float(torch.linalg.matrix_norm(H)) / n
    m = na + na % 2
    sweeps = rotations = 0
    while True:
        off = (A - torch.diag(torch.diagonal(A))).abs().max() if na else 0.0
        if not float(off) > delta:
            converged = True
            break
        if sweeps == max_sweeps:
            converged = False
            break
        sweeps += 1
        for r in range(m - 1):
            pq = [(p, q) for p, q in _round_pairs(m, r)
                  if q < na and abs(float(A[p, q])) > delta]
            if not pq:
                continue
            p, q = (torch.tensor(x) for x in zip(*pq))
            apq, app, aqq = A[p, q], A[p, p], A[q, q]
            theta = (aqq - app) / (2 * apq)
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                theta.abs() + torch.sqrt(theta * theta + 1))
            c = 1 / torch.sqrt(t * t + 1)
            s = t * c
            dp, dq = app - t * apq, aqq + t * apq
            x, y = A[p].clone(), A[q].clone()
            A[p] = c[:, None] * x - s[:, None] * y
            A[q] = s[:, None] * x + c[:, None] * y
            for M in (A, V):
                x, y = M[:, p].clone(), M[:, q].clone()
                M[:, p] = c * x - s * y
                M[:, q] = s * x + c * y
            A[p, q] = 0.0
            A[q, p] = 0.0
            A[p, p] = dp
            A[q, q] = dq
            rotations += len(pq)
    lam = torch.diagonal(A)
    neg = lam < 0
    out = H.clone()
    out[act[:, None], act[None, :]] -= (V[:, neg] * lam[neg]) @ V[:, neg].T
    return out, sweeps, rotations, converged


@pytest.mark.parametrize("n,drop", [(20, range(9, 18)), (45, range(0, 9)),
                                    (33, list(range(27, 33)) + [0])])
def test_jacobi_walk_matches_the_eigh_clip(n, drop):
    S, rhs, pd = _indefinite(n, drop, 100 + n)
    H, g, _ = _direct_prior(S, rhs, pd, 1e-9)
    evals = torch.linalg.eigvalsh(H)
    assert float(evals.min()) < -1e-3 * float(evals.max())   # clips
    got, sweeps, rotations, converged = jacobi_clip_walk(H)
    want, gp = k11.marginalize_prior_plain(S, rhs, pd, 1e-9)
    norm = float(torch.linalg.matrix_norm(want))
    assert converged and sweeps <= 12, sweeps
    assert rotations > 0
    assert float((got - want).abs().max()) <= 1e-10 * norm
    assert float(torch.linalg.eigvalsh(got).min()) >= -1e-12 * norm
    assert_rel(g, gp.numpy(), 1e-12, "g")


def test_jacobi_walk_leaves_a_psd_prior_unchanged():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((24, 30))
    H = torch.as_tensor(A @ A.T)
    got, sweeps, _, converged = jacobi_clip_walk(H)
    assert converged and sweeps > 0
    assert float((got - H).abs().max()) <= 1e-14 * float(H.abs().max())


# ---- K11 (b1): the PSD certificate ---------------------------------------

# csrc/marginalize.cu's shift tau / ||H||_F per dtype
CERT_TAU = {torch.float32: 1e-8, torch.float64: 1e-12}


def certificate_walk(H):
    """csrc/marginalize.cu (b1) in torch: H_aa + tau I on the active dims
    (rows of H not exactly zero), tau = CERT_TAU ||H||_F, factorized in
    f64 by the right-looking Cholesky, a_ij -= (a_ik / a_kk) a_jk column by
    column.  Returns (every pivot positive, tau)."""
    Hd = H.double()
    act = (Hd != 0).any(1)
    tau = CERT_TAU[H.dtype] * float(torch.linalg.matrix_norm(Hd))
    A = Hd[act][:, act] + tau * torch.eye(int(act.sum()),
                                          dtype=torch.float64)
    for k in range(A.shape[0]):
        d = float(A[k, k])
        if not d > 0.0:
            return False, tau
        lik = A[k + 1:, k] * (1.0 / d)
        A[k + 1:, k + 1:] -= torch.outer(lik, A[k + 1:, k])
    return True, tau


def _jax_eigh_clip(H):
    """ba_tpu/solver/window.py:126-127, the clip, on the CPU in f64."""
    Hj = jnp.asarray(H.double().numpy())
    evals, evecs = jnp.linalg.eigh(Hj)
    return np.asarray((evecs * jnp.maximum(evals, 0.0)[None, :]) @ evecs.T)


@pytest.mark.parametrize("family,dtype,certifies", [
    ("gauge", torch.float64, True),
    ("psd", torch.float64, True),
    ("psd", torch.float32, True),
    ("neg_in", torch.float64, True),
    ("neg_in", torch.float32, True),
    ("neg_out", torch.float64, False),
    ("neg_out", torch.float32, False),
    ("indefinite", torch.float64, False),
    ("indefinite", torch.float32, False)])
def test_certificate_walk_certifies_where_expected(family, dtype, certifies):
    S, rhs, pd = chip_smoke.certificate_case(family, 40, dtype,
                                             device="cpu")
    eps = 1e-9 if dtype == torch.float64 else 1e-5
    if dtype == torch.float64:
        H, _, _ = _direct_prior(S, rhs, pd, eps)
    else:                      # the f32 prior, as the kernel forms it
        H, _, _ = _direct_prior(S.double(), rhs.double(), pd, eps)
        H = H.float()
    got, tau = certificate_walk(H)
    assert got == certifies, (family, dtype)
    clip = _jax_eigh_clip(H)
    gap = float(np.linalg.norm(H.double().numpy() - clip))
    norm = float(np.linalg.norm(clip))
    n_neg = int((np.linalg.eigvalsh(H.double().numpy()) < 0).sum())
    if certifies:
        # the kernel returns H itself: within sqrt(#neg) tau of the clip
        # (plus f64 eigh's roundoff)
        assert gap <= np.sqrt(max(n_neg, 1)) * tau + 1e-13 * norm, gap
    else:
        # the clip's move is larger than the certificate allows, and the
        # kernel's Jacobi walk gives ba_tpu's clip
        assert gap > tau
        walked = jacobi_clip_walk(H.double())[0]
        assert float(np.abs(walked.numpy() - clip).max()) <= 1e-10 * norm


# ---- K5: the tile-mask schedule ------------------------------------------

def k5_schedule_walk(U, W, vinv, rhs_p, rhs_l, cmask=None, n=None, tile=32,
                     cs=1, dense=False):
    """csrc/schur_finish.cu in torch: a landmark mask per 32 rows of W
    (some row of the range nonzero in the landmark's lm columns); for each
    lower tile (I, J) the landmarks set in both its masks (every landmark
    with `dense`), ascending; split across `cs` blocks, block r takes those
    in the 32-landmark words w = r mod cs, and the partial tiles are summed
    in rank order; a share adds its columns' outer products of W V^-1
    (rows I) and W (rows J) one column at a time.  Returns (S, rhs, tile
    pairs with no common landmark)."""
    N = U.shape[0]
    L, lm, _ = vinv.shape
    n = N if n is None else n
    WVi = torch.einsum("nlk,lkj->nlj", W.reshape(N, L, lm),
                       vinv).reshape(N, L * lm)
    nz = (W[:n].reshape(n, L, lm) != 0).any(2)
    ranges = [nz[r:r + 32].any(0) for r in range(0, n, 32)]
    S = torch.empty((n, n), dtype=U.dtype)
    nb, empty = -(-n // tile), 0
    for bi in range(nb):
        for bj in range(bi + 1):
            I = slice(bi * tile, min(n, (bi + 1) * tile))
            J = slice(bj * tile, min(n, (bj + 1) * tile))
            mI = torch.stack(ranges[bi * tile // 32:
                                    -(-min(n, (bi + 1) * tile) // 32)]).any(0)
            mJ = torch.stack(ranges[bj * tile // 32:
                                    -(-min(n, (bj + 1) * tile) // 32)]).any(0)
            common = torch.nonzero(torch.ones_like(mI) if dense
                                   else mI & mJ).reshape(-1).tolist()
            empty += not common
            acc = None
            for q in range(cs):
                part = torch.zeros((I.stop - I.start, J.stop - J.start),
                                   dtype=U.dtype)
                for l in [l for l in common if (l // 32) % cs == q]:
                    for b in range(lm):
                        c = l * lm + b
                        part = part + torch.outer(WVi[I, c], W[J, c])
                acc = part if acc is None else acc + part
            S[I, J] = U[I, J] - acc
            S[J, I] = S[I, J].T
    if cmask is not None:
        S = S + torch.diag(torch.where(cmask, 0.0, 1e6).to(S.dtype))
    rhs = (rhs_p - WVi @ rhs_l)[:n]
    if cmask is not None:
        rhs = torch.where(cmask, rhs, 0.0)
    return S, rhs, empty


def _banded_contribution(P, D, L, lm, seed, span=3):
    """A contribution whose W is block-banded: landmark l seen by `span`
    consecutive poses, so distant tile pairs share no landmark."""
    c, cmask = _contribution(P, D, L, lm, seed)
    rng = np.random.default_rng(seed + 1)
    W = np.zeros((P * D, L * lm))
    for l in range(L):
        p0 = int(rng.integers(0, P - span + 1))
        W[p0 * D:(p0 + span) * D, l * lm:(l + 1) * lm] = \
            rng.standard_normal((span * D, lm))
    c["W"] = W
    return c, cmask


@pytest.mark.parametrize("lm,tile,cs,n_cut,masked,L", [
    (1, 32, 1, 0, True, 30),
    (3, 32, 1, 0, True, 30),
    (1, 64, 1, 0, False, 30),
    (1, 32, 3, 0, True, 70),
    (3, 32, 8, 0, False, 70),
    (1, 32, 1, 9, False, 30),
    (1, 32, 1, 0, True, 0)])
def test_k5_schedule_walk_matches_the_dense_walk_and_finish(lm, tile, cs,
                                                            n_cut, masked, L):
    c, cmask = _banded_contribution(16, 9, max(L, 1), lm, 3 + lm + cs)
    if L == 0:
        c["W"] = c["W"][:, :0]
        c["V"] = c["V"][:0]
        c["rhs_l"] = c["rhs_l"][:0]
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    N = t["U"].shape[0]
    n = N - n_cut
    cm = torch.as_tensor(cmask[:n]) if masked else None
    args = (t["U"], t["W"], block_diag_inv(t["V"]), t["rhs_p"], t["rhs_l"])
    S, rhs, empty = k5_schedule_walk(*args, cm, n, tile, cs)
    if L:
        assert empty > 0                 # some tile pair is skipped whole
    if cs == 1:
        Sd, rhsd, _ = k5_schedule_walk(*args, cm, n, tile, 1, dense=True)
        assert torch.equal(S, Sd) and torch.equal(rhs, rhsd)
    assert torch.equal(S, S.T)
    Sp, rhsp = k5.schur_finish_plain(*args, cm, n)
    assert_rel(S, Sp.numpy(), 1e-12, "S")
    assert_rel(rhs, rhsp.numpy(), 1e-12, "rhs")
    if n == N:
        want = jasm.finish(jasm.Contribution(**{k: jnp.asarray(v)
                                                for k, v in c.items()}),
                           jnp.asarray(cmask if masked
                                       else np.ones(N, bool)), None)
        assert_rel(S, np.asarray(want.S), 1e-12, "S")
        assert_rel(rhs, np.asarray(want.rhs_sc), 1e-12, "rhs")
