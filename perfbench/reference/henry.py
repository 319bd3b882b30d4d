"""Variable-density groundwater flow and solute transport on a DIS
cross-section in plain PyTorch: the Henry (1964) seawater-intrusion
problem as MODFLOW 6's example ex-gwt-henry states it.

Each time step solves the flow first, then the transport on its flows
(one solution group, MXITER 1):

- flow, steady (no storage): NPF's harmonic-mean conductances of confined
  cells (gwf-npf.f90 calc_condsat), BUY's hydraulic-head formulation with
  its terms on the left-hand side (gwf-buy.f90 calchhterms, iform 2) at the
  step-start concentration through the linear equation of state
  (calcdens), WEL as a fixed inflow, CHD as constant heads (IMS's fixup of
  their rows, NumericalSolution.f90 sln_ls, without moving their columns:
  BiCGSTAB keeps them);
- FMI: the face flows of the flow solution (npf_cq plus buy_cq), the
  WEL entries' flows and the CHD cells' flows (minus the net face flow
  into each);
- transport: upstream advection (tsp-adv.f90 adv_fc), molecular
  diffusion alone (gwt-dsp.f90 calcdispcoef, no mechanical dispersion),
  MST storage of the mobile phase, SSM (an inflow at its source's
  concentration, an outflow at the cell's), from the step-start
  concentration;
- the Picard outer loop and BiCGSTAB with IMS's exit rules
  (ImsLinearBase.f90 ims_base_bcgs, ims_base_testcnvg with ICNVGOPT 0):
  the flow preconditioned by a pooled multigrid V-cycle, the transport
  by Jacobi.

Departures from MODFLOW 6: ILU(0) (the source's preconditioner, with its
relaxation factor) is replaced by the V-cycle and by Jacobi, as the
program replaces it; the V-cycle is this module's own copy of the
program's (2 x 2 aggregation, piecewise-constant transfers, Chebyshev
smoothing on the Jacobi-scaled operator, with the program's constants),
on the (layer, column) plane of a one-row section and on the (row,
column) plane otherwise.  Sums are taken in the order the program takes
them (the slots east, west, north, south, up, down), so that on one device
the f64 program agrees with this far inside the closures.

Arrays are dense (nlay, nrow, ncol) planes; Krylov vectors are flat.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flow import SLOTS
from .krylov import _nudge, jacobi, signed_absmax

EPS = 2.220446049250313e-16
# the V-cycle's constants: the Chebyshev window of Jacobi-scaled CVFD
# stencils, the smoothing and coarse-grid windows, and the cycle's shape
LMAX = 2.05
SMOOTH_LO = LMAX / 4.0
COARSE_LO = LMAX / 64.0
NSMOOTH, COARSE_SIZE, COARSE_ORDER, MAX_LEVELS, OVERCORRECT = \
    2, 512, 16, 12, 1.8


# ------------------------------------------------------------- Krylov


def _same(a, b):
    """a and b (host floats) within 100 float64 machine epsilons."""
    return a == b or abs(a - b) <= 100.0 * EPS * max(abs(a), abs(b))


def _dot(a, b):
    return torch.sum(a * b)


def bicgstab(matvec, b, x, precond, itmax, dvclose, rclose):
    """Returns (x, iterations).  Stops when the update's largest change is
    within ``dvclose`` and the residual's largest entry within ``rclose``,
    when rho, alpha or omega stagnates, or at ``itmax``.  The scalars of
    the exit test are read on the host once an iteration and tested there
    in float64, as on the device."""
    d = b - matvec(x)
    dhat = d
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    rho0, alpha0, omega0 = zero, zero, zero
    last = (0.0, 0.0, 0.0)
    it = 0
    while it < itmax:
        rho = _dot(dhat, d)
        if it == 0:
            p = d
        else:
            beta = ((rho / torch.where(rho0 != 0.0, rho0, 1.0))
                    * (alpha0 / torch.where(omega0 != 0.0, omega0, 1.0)))
            p = d + beta * (p - omega0 * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho / _nudge(_dot(dhat, v))
        q = d - alpha * v
        qhat = precond(q)
        t = matvec(qhat)
        omega = _dot(t, q) / _nudge(_dot(t, t))
        tv = alpha * phat + omega * qhat
        x = x + tv
        d = q - omega * t
        scalars = torch.stack((rho, alpha, omega, signed_absmax(tv),
                               signed_absmax(d))).tolist()
        now, (dvmax, rmax) = scalars[:3], scalars[3:]
        conv = (abs(dvmax) <= dvclose and abs(rmax) <= rclose) \
            or rmax == 0.0
        stagnant = any(_same(a, b) for a, b in zip(now, last))
        it += 1
        if conv or stagnant or now[0] * now[2] == 0.0:
            break
        rho0, alpha0, omega0 = rho, alpha, omega
        last = now
    return x, it


def picard(system, x, active, ims, make_precond):
    """The outer loop of one time step: ``system(x)`` gives the fixed-up
    (matvec, diag, off, rhs) at the iterate ``x``.  Returns (x, outer,
    inner, converged)."""
    inner = 0
    for outer in range(1, ims["outer_maximum"] + 1):
        matvec, diag, off, rhs = system(x)
        xnew, its = bicgstab(matvec, rhs, x, make_precond(diag, off),
                             ims["inner_maximum"], ims["inner_dvclose"],
                             ims["inner_rclose"])
        inner += its
        dxmax = signed_absmax(torch.where(active, xnew - x, 0.0))
        x = xnew
        if bool(dxmax.abs() <= ims["outer_dvclose"]):
            return x, outer, inner, True
    return x, ims["outer_maximum"], inner, False


# ----------------------------------------------------------- multigrid


def neighbours(x3):
    """The value of each cell's neighbour in each slot [E, W, N, S, U, D]
    (0 beyond the border), as views of one zero-padded copy; None for a
    slot along an axis of extent one, which has no neighbour at all."""
    pad = [0] * 6
    for axis in range(3):
        if x3.shape[axis] > 1:
            pad[4 - 2 * axis] = pad[5 - 2 * axis] = 1
    xp = F.pad(x3, pad)
    out = []
    for axis, d in SLOTS:
        if x3.shape[axis] == 1:
            out.append(None)
            continue
        idx = []
        for a in range(3):
            lo = (1 if x3.shape[a] > 1 else 0) + (d if a == axis else 0)
            idx.append(slice(lo, lo + x3.shape[a]))
        out.append(xp[tuple(idx)])
    return out


def stencil(shape, diag, c):
    """y = A x of a 7-point system given as its diagonal and the [..., 6]
    slot planes [E, W, N, S, U, D], as shifted multiply-adds in the slots'
    order (a slot without neighbours adds nothing)."""
    def apply(x):
        x3 = x.reshape(shape)
        y = diag.reshape(shape) * x3
        for s, xn in enumerate(neighbours(x3)):
            if xn is not None:
                y = y + c[..., s] * xn
        return y.reshape(-1)
    return apply


def _cheb_coefs(order, lo, hi):
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    coefs = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coefs


def _chebyshev(mv, inv, r, z0, order, lo, hi):
    theta, coefs = _cheb_coefs(order, lo, hi)
    if z0 is None:
        d = (inv * r) / theta
        z = d
    else:
        d = (inv * (r - mv(z0))) / theta
        z = z0 + d
    for c_d, c_r in coefs:
        d = c_d * d + c_r * (inv * (r - mv(z)))
        z = z + d
    return z


def _pad_even(a):
    """Zero rows and columns (the view's second and third axes) up to even
    sizes."""
    pr, pc = a.shape[1] % 2, a.shape[2] % 2
    if pr == 0 and pc == 0:
        return a
    return F.pad(a, (0, 0) * (a.ndim - 3) + (0, pc, 0, pr))


def _coarsen(diag3, c):
    """The Galerkin product of 2 x 2 aggregation: pooled sums of the fine
    coefficients; the coarse diagonal also takes the couplings inside each
    aggregate."""
    diag3, c = _pad_even(diag3), _pad_even(c)
    nl, nr, nc = diag3.shape
    nr, nc = nr // 2, nc // 2

    def split(a):
        return a.reshape(nl, nr, 2, nc, 2)

    def pool(a):
        return split(a).sum(dim=(2, 4))

    cE, cW, cN, cS, cU, cD = (c[..., i] for i in range(6))
    coarse = [split(cE)[:, :, :, :, 1].sum(dim=2),
              split(cW)[:, :, :, :, 0].sum(dim=2),
              split(cN)[:, :, 0, :, :].sum(dim=3),
              split(cS)[:, :, 1, :, :].sum(dim=3), pool(cU), pool(cD)]
    inside = (split(cE)[:, :, :, :, 0].sum(dim=2)
              + split(cW)[:, :, :, :, 1].sum(dim=2)
              + split(cS)[:, :, 0, :, :].sum(dim=3)
              + split(cN)[:, :, 1, :, :].sum(dim=3))
    dc = pool(diag3) + inside
    dc = torch.where(dc.abs() < 1e-300, -1.0, dc)
    return dc, torch.stack(coarse, dim=-1)


def _restrict(r3):
    r3 = _pad_even(r3)
    nl, nr, nc = r3.shape
    return r3.reshape(nl, nr // 2, 2, nc // 2, 2).sum(dim=(2, 4))


def _prolong(z, shape):
    return z.repeat_interleave(2, dim=1).repeat_interleave(
        2, dim=2)[:, :shape[1], :shape[2]]


def vcycle_preconditioner(shape, diag, off):
    """z ~ A^-1 r by one V-cycle.  A one-row section with more than two
    layers is coarsened over (layer, column): its (nlay, 1, ncol) planes
    are read as (1, nlay, ncol), the up and down couplings in the north
    and south places.  ``apply.levels`` counts the levels."""
    nlay, nrow, ncol = shape
    c = off.reshape(shape + (6,))
    if nrow == 1 and nlay > 2:
        shape = (1, nlay, ncol)
        c = c.reshape(shape + (6,))[..., [0, 1, 4, 5, 2, 3]]
    d3 = diag.reshape(shape)
    levels = []
    while True:
        inv = 1.0 / torch.where(d3 != 0.0, d3, 1.0)
        levels.append((tuple(d3.shape), stencil(tuple(d3.shape), d3, c),
                       inv))
        nl, nr, nc = d3.shape
        if (nl * nr * nc <= COARSE_SIZE or min(nr, nc) <= 2
                or len(levels) >= MAX_LEVELS):
            break
        d3, c = _coarsen(d3, c)

    def cycle(level, r3):
        lshape, mv, inv = levels[level]
        flat = r3.reshape(-1)
        invf = inv.reshape(-1)
        if level == len(levels) - 1:
            return _chebyshev(mv, invf, flat, None, COARSE_ORDER, COARSE_LO,
                              LMAX).reshape(lshape)
        z = _chebyshev(mv, invf, flat, None, NSMOOTH, SMOOTH_LO, LMAX)
        resid = (flat - mv(z)).reshape(lshape)
        zc = cycle(level + 1, _restrict(resid))
        z = z + OVERCORRECT * _prolong(zc, lshape).reshape(-1)
        return _chebyshev(mv, invf, flat, z, NSMOOTH, SMOOTH_LO,
                          LMAX).reshape(lshape)

    def apply(r):
        return cycle(0, r.reshape(shape)).reshape(-1)

    apply.levels = len(levels)
    return apply


# --------------------------------------------------------------- model


class HenrySection:
    """The coupled model of one case (``section.SectionInputs``) on
    ``device`` in float64."""

    def __init__(self, inp, device):
        f64 = torch.float64
        self.shape = shape = inp.shape
        self.n = inp.nodes
        self.device = device

        def t(a):
            return torch.as_tensor(a, dtype=f64, device=device)

        top, bot = t(inp.top).reshape(shape), t(inp.bot).reshape(shape)
        self.top, self.bot = top, bot
        delr, delc = t(inp.delr), t(inp.delc)
        self.delr, self.delc = delr, delc
        area = (delc[:, None] * delr[None, :])[None]
        k = torch.full(shape, inp.k, dtype=f64, device=device)
        thick = 1.0 * (top - bot)
        # harmonic-mean conductances at full saturation
        tk = k * thick
        self.cx = self._hmean(tk[:, :, :-1], tk[:, :, 1:],
                              0.5 * delr[:-1][None, None, :],
                              0.5 * delr[1:][None, None, :],
                              delc[None, :, None])
        self.cy = self._hmean(tk[:, :-1, :], tk[:, 1:, :],
                              0.5 * delc[:-1][None, :, None],
                              0.5 * delc[1:][None, :, None],
                              delr[None, None, :])
        bovk = thick * 0.5 / k
        den = bovk[:-1] + bovk[1:]
        self.cz = torch.where(den != 0.0, area / torch.where(
            den != 0.0, den, 1.0), 0.0)
        # BUY: the weights of each face's two cells and the cells' centres
        half = 0.5 * (top - bot)
        self.wt = (0.5 * delr[:-1] / (0.5 * delr[:-1] + 0.5 * delr[1:]))[
            None, None, :], \
            (0.5 * delc[:-1] / (0.5 * delc[:-1] + 0.5 * delc[1:]))[
                None, :, None], \
            half[:-1] / (half[:-1] + half[1:])
        self.elev = bot + 0.5 * 1.0 * (top - bot)
        buy = inp.buy
        self.denseref = float(buy["denseref"])
        self.drhodc = float(buy["drhodc"])
        self.crhoref = float(buy["crhoref"])
        if int(buy.get("iform", 2)) != 2:
            raise ValueError("the reference follows BUY's iform 2 only")
        # boundaries
        self.chd_node = torch.as_tensor(inp.chd_node, device=device)
        self.chd_head = t(inp.chd_head)
        self.chd_conc = inp.chd_conc
        fixed = torch.zeros(self.n, dtype=torch.bool, device=device)
        fixed[self.chd_node] = True
        self.fixed = fixed
        self.wel_node = torch.as_tensor(inp.wel_node, device=device)
        self.wel_q = t(inp.wel_q)
        self.wel_conc = inp.wel_conc
        # transport: diffusion times porosity on each cell, the cells'
        # pore volumes, the diffusion conductances of the faces
        self.porosity = inp.porosity
        dstar = torch.full(shape, inp.diffc, dtype=f64,
                           device=device) * inp.porosity
        self.vol = area * (top - bot) * 1.0 * inp.porosity
        thk = (top - bot) * 1.0
        self.dx = self._dcond(dstar[:, :, :-1], dstar[:, :, 1:],
                              thk[:, :, :-1] * delc[None, :, None],
                              thk[:, :, 1:] * delc[None, :, None],
                              (0.5 * delr[:-1])[None, None, :],
                              (0.5 * delr[1:])[None, None, :])
        self.dy = self._dcond(dstar[:, :-1, :], dstar[:, 1:, :],
                              thk[:, :-1, :] * delr[None, None, :],
                              thk[:, 1:, :] * delr[None, None, :],
                              (0.5 * delc[:-1])[None, :, None],
                              (0.5 * delc[1:])[None, :, None])
        az = area.expand(shape)[:-1]
        self.dz = self._dcond(dstar[:-1], dstar[1:], az, az,
                              1.0 * thk[:-1] * 0.5, 1.0 * thk[1:] * 0.5)

    @staticmethod
    def _hmean(t1, t2, cl1, cl2, width):
        den = t1 * cl2 + t2 * cl1
        return torch.where(t1 * t2 > 0.0, width * t1 * t2 / torch.where(
            den != 0.0, den, 1.0), 0.0)

    @staticmethod
    def _dcond(dn, dm, anm, amn, clnm, clmn):
        """Two half-cell diffusion conductances in series."""
        cn = torch.where(clnm > 0.0, dn * anm / torch.where(
            clnm > 0.0, clnm, 1.0), 0.0)
        cm = torch.where(clmn > 0.0, dm * amn / torch.where(
            clmn > 0.0, clmn, 1.0), 0.0)
        den = cn + cm
        return torch.where(den > 0.0, cn * cm / torch.where(
            den > 0.0, den, 1.0), 0.0)

    def density(self, conc):
        return self.denseref + self.drhodc * (conc - self.crhoref)

    # ------------------------------------------------------------ flow

    def _buy_faces(self, conc):
        """Per axis (x, y, z): (weight, rho_n, rho_m, drho, elev_n,
        elev_m) of each face, n the lower-numbered cell."""
        dens = self.density(conc).reshape(self.shape)
        out = []
        for axis, w in zip((2, 1, 0), self.wt):
            n, m = _split(dens, axis)
            en, em = _split(self.elev, axis)
            rn, rm = n / self.denseref, m / self.denseref
            out.append((w, rn, rm, rm - rn, en, em))
        return out

    def raw_flow_system(self, conc):
        """(diag, [..., 6] slot planes, rhs) of the steady flow at the
        concentration ``conc``, before the fixup."""
        cx, cy, cz = self.cx, self.cy, self.cz
        cE, cW = F.pad(cx, (0, 1)), F.pad(cx, (1, 0))
        cS, cN = F.pad(cy, (0, 0, 0, 1)), F.pad(cy, (0, 0, 1, 0))
        cD, cU = F.pad(cz, (0, 0, 0, 0, 0, 1)), F.pad(cz, (0, 0, 0, 0, 1, 0))
        diag = (-(cE + cW + cS + cN) + F.pad(-cz, (0, 0, 0, 0, 0, 1))
                + F.pad(-cz, (0, 0, 0, 0, 1, 0)))
        c = torch.stack([cE, cW, cN, cS, cU, cD], dim=-1)
        rhs = torch.zeros(self.shape, dtype=diag.dtype, device=self.device)
        # BUY, iform 2: per face the lhs terms of both rows and the
        # elevation terms of the rhs, axis by axis (x, y, z)
        for (w, rn, rm, drho, en, em), cond, (axis, s_n, s_m) in zip(
                self._buy_faces(conc), (cx, cy, cz), _AXES):
            amat = cond * ((w * rn + (1.0 - w) * rm) - 1.0)
            elev_nm = (1.0 - w) * en + w * em
            elev_mn = (1.0 - (1.0 - w)) * em + (1.0 - w) * en
            ns, ms = _sides(axis)
            rhs[ns] += -(-cond * drho * elev_nm)
            rhs[ms] += -(cond * drho * elev_mn)
            diag[ns] += -amat + cond * (1.0 - w) * drho
            diag[ms] += -amat - cond * w * drho
            c[ns + (s_n,)] += amat + cond * w * drho
            c[ms + (s_m,)] += amat - cond * (1.0 - w) * drho
        rhs = rhs.reshape(-1)
        rhs[self.wel_node] += -self.wel_q
        return diag.reshape(-1), c, rhs

    def flow_system(self, conc, x):
        """The fixed-up flow system at the iterate ``x``: constant-head
        rows become identity rows with the iterate's value."""
        diag, c, rhs = self.raw_flow_system(conc)
        act = ~self.fixed
        diag = torch.where(act, diag, 1.0)
        c = torch.where(act.reshape(self.shape)[..., None], c, 0.0)
        rhs = torch.where(act, rhs, x)
        return stencil(self.shape, diag, c), diag, c, rhs

    def pin(self, h):
        h = h.reshape(-1).clone()
        h[self.chd_node] = self.chd_head
        return h

    def flow_step(self, h_old, conc, ims):
        """The steady flow at ``conc`` from the heads ``h_old``: (heads,
        outer, inner, converged)."""
        h0 = self.pin(h_old)
        shape = self.shape

        def system(x):
            return self.flow_system(conc, x)

        def mg(diag, c):
            return vcycle_preconditioner(shape, diag, c)
        return picard(system, h0, ~self.fixed, ims, mg)

    def residual(self, h, conc):
        """max |b - A h| of the steady flow at ``conc`` over the cells that
        are not constant-head, in the units of a flow rate (L^3/T)."""
        diag, c, rhs = self.raw_flow_system(conc)
        r = rhs - stencil(self.shape, diag, c)(h.reshape(-1))
        return float(torch.where(self.fixed, 0.0, r).abs().max())

    # ------------------------------------------------------------ FMI

    def face_flows(self, h, conc):
        """(qx, qy, qz): the flow across each face into its
        lower-numbered cell, with BUY's part."""
        h3 = h.reshape(self.shape)
        out = []
        for (w, rn, rm, drho, en, em), cond, (axis, _, _) in zip(
                self._buy_faces(conc), (self.cx, self.cy, self.cz), _AXES):
            hn, hm = _split(h3, axis)
            amat = cond * ((w * rn + (1.0 - w) * rm) - 1.0)
            hphi = (1.0 - w) * hn + w * hm
            elev_nm = (1.0 - w) * en + w * em
            out.append(cond * (hm - hn)
                       + (amat * (hm - hn) + cond * drho * (hphi - elev_nm)))
        return out

    def chd_flows(self, qx, qy, qz):
        """Into the aquifer at each CHD cell: minus the net face flow into
        it, summed over [0, up, north, west, east, south, down]."""
        cols = [torch.zeros(self.shape, dtype=qx.dtype, device=self.device),
                -F.pad(qz, (0, 0, 0, 0, 1, 0)), -F.pad(qy, (0, 0, 1, 0)),
                -F.pad(qx, (1, 0)), F.pad(qx, (0, 1)),
                F.pad(qy, (0, 0, 0, 1)), F.pad(qz, (0, 0, 0, 0, 0, 1))]
        into = torch.stack(cols, dim=-1).reshape(-1, 7).sum(dim=1)
        return -into[self.chd_node]

    # ------------------------------------------------------- transport

    def transport_system(self, flows, c_old, delt):
        """(diag, [..., 6] slot planes, rhs) of the transport on the face
        flows ``flows`` from ``c_old`` over ``delt``."""
        shape = self.shape
        sd = [torch.zeros(shape, dtype=c_old.dtype, device=self.device)
              for _ in range(6)]
        so = [torch.zeros(shape, dtype=c_old.dtype, device=self.device)
              for _ in range(6)]
        for q, (axis, s_n, s_m) in zip(flows, _AXES):
            ns, ms = _sides(axis)
            om_n = (~(q > 0.0)).to(q.dtype)
            om_m = (~(-q > 0.0)).to(q.dtype)
            sd[s_n][ns] = q * om_n
            sd[s_m][ms] = -q * om_m
            so[s_n][ns] = q * (1.0 - om_n)
            so[s_m][ms] = -q * (1.0 - om_m)
        diag = torch.stack(sd, dim=-1).reshape(-1, 6).sum(dim=1)
        dd = [torch.zeros_like(sd[0]) for _ in range(6)]
        for dc, (axis, s_n, s_m) in zip((self.dx, self.dy, self.dz), _AXES):
            ns, ms = _sides(axis)
            so[s_n][ns] += dc
            so[s_m][ms] += dc
            dd[s_n][ns] = -dc
            dd[s_m][ms] = -dc
        diag = diag + torch.stack(dd, dim=-1).reshape(-1, 6).sum(dim=1)
        tled = 1.0 / delt
        vol = self.vol.reshape(-1)
        diag = diag + (-vol * tled)
        rhs = torch.zeros_like(diag) + (-(vol + 0.0 * delt) * tled) * c_old
        # SSM: the WEL entries, then the CHD cells
        q_wel = self.wel_q
        q_chd = self.chd_flows(*flows)
        for node, q, conc in ((self.wel_node, q_wel, self.wel_conc),
                              (self.chd_node, q_chd, self.chd_conc)):
            inflow = q >= 0.0
            rhs[node] += torch.where(inflow, -q * conc, 0.0)
            diag[node] += torch.where(inflow, 0.0, q)
        return diag, torch.stack(so, dim=-1), rhs

    def transport_step(self, flows, c_old, delt, ims):
        """(concentration, outer, inner, converged) of one step."""
        shape = self.shape
        diag, c, rhs = self.transport_system(flows, c_old, delt)

        def system(x):
            return _gathered(shape, diag, c), diag, c, rhs
        return picard(system, c_old.reshape(-1),
                      torch.ones_like(self.fixed), ims,
                      lambda diag, off: jacobi(diag))

    def step(self, h_old, c_old, delt, flow_ims, transport_ims):
        """One coupled time step: (heads, concentration, (flow outer,
        inner, converged), (transport outer, inner, converged))."""
        h, fo, fi, fc = self.flow_step(h_old, c_old, flow_ims)
        flows = self.face_flows(h, c_old)
        c, to, ti, tc = self.transport_step(flows, c_old, delt,
                                            transport_ims)
        return h, c, (fo, fi, fc), (to, ti, tc)


# (axis, slot of the lower-numbered cell, slot of the other) per axis
_AXES = ((2, 0, 1), (1, 3, 2), (0, 5, 4))


def _sides(axis):
    """The index tuples of the lower- and higher-numbered cell of each
    face along ``axis``."""
    n = [slice(None)] * 3
    m = [slice(None)] * 3
    n[axis], m[axis] = slice(None, -1), slice(1, None)
    return tuple(n), tuple(m)


def _split(a, axis):
    ns, ms = _sides(axis)
    return a[ns], a[ms]


def _gathered(shape, diag, c):
    """y = A x with the six slot products summed as one reduction over
    [E, W, N, S, U, D]; a slot without a neighbour adds zero."""
    zero = torch.zeros(shape, dtype=diag.dtype, device=diag.device)

    def apply(x):
        prods = torch.stack([zero if xn is None else c[..., s] * xn
                             for s, xn in
                             enumerate(neighbours(x.reshape(shape)))],
                            dim=-1)
        return diag * x + prods.reshape(-1, 6).sum(dim=1)
    return apply
