"""The LM step's Jacobian products (``ezpz_tpu_torch/ops/lm_jacobian.py``)
on the CPU.

* The kernel's instance table writes each product where ``_assembly``'s
  plan reads it: rebuilt from the table in the plan's order (block,
  instance, then k, l), the JtJ and Jtr contribution lists are the plan's
  gather rows, column for column, and the columns are each written once.
  Topologies: ``rect_chain(64)`` (the benchmark's), ``rect_grid(8, 8)``
  and a system of every kind whose first instance of each kind names one
  variable twice.
* ``CompiledSystem.normal_equations`` gives the residual, JtJ (dense, in
  diagonal blocks, or in the band), Jtr and the degenerate flags that it
  gave before the products moved into ``ops.lm_jacobian``, ``torch.equal``
  (``_before`` keeps that code: one ``torch.func.jvp`` pass per instance
  variable, one op per product, the product lists concatenated and summed
  by ``gather_sum``), in f32 and f64, with and without an f64 rhs, with
  per-lane and compile-time parameters; and on the CPU it launches no
  kernel (``lm.jac_kernel`` and ``LAUNCHES`` unchanged).
* A wider rhs gives what its first ``n_rows`` columns give.
* The per-device tables are made once (four counted copies) and shared by
  every later call; a CUDA-only input on another device is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ezpz_tpu_torch import fixtures, tracing
from ezpz_tpu_torch.batch import _pick_spd
from ezpz_tpu_torch.models.compiled import compile_system, gather_sum
from ezpz_tpu_torch.ops import banded, lm_jacobian

B = 3


def _system(name):
    if name == "every_kind":
        return fixtures.every_kind(per_kind=3, n_vars=24, seed=7)
    cons, x0 = {"rect_chain(64)": lambda: fixtures.rect_chain(64),
                "rect_chain(8)": lambda: fixtures.rect_chain(8),
                "rect_grid(8,8)": lambda: fixtures.rect_grid(8, 8)}[name]()
    return compile_system(cons, len(x0))


@pytest.mark.parametrize("name", ["rect_chain(64)", "rect_grid(8,8)", "every_kind"])
def test_instance_table_writes_where_the_assembly_reads(name):
    system = _system(name)
    inst, n_jj, n_jr, n_deg = lm_jacobian.instance_table(system.blocks)
    assert inst.shape == (sum(b.idx.shape[0] for b in system.blocks), lm_jacobian.IC_COLS)
    jj_lists, jr_lists, jj_cols, jr_cols = {}, {}, [], []
    n = system.n_vars
    g = 0
    for b, blk in enumerate(system.blocks):
        nb, nv = blk.idx.shape
        for i in range(nb):
            row = inst[g]
            assert (row[lm_jacobian.IC_BLOCK], row[lm_jacobian.IC_INDEX],
                    row[lm_jacobian.IC_NB]) == (b, i, nb)
            ids = row[lm_jacobian.IC_IDS:lm_jacobian.IC_IDS + nv].tolist()
            assert ids == blk.idx[i].tolist()
            for k in range(nv):
                col = int(row[lm_jacobian.IC_JR]) + k * nb
                jr_lists.setdefault(ids[k], []).append(col)
                jr_cols.append(col)
                for l in range(nv):
                    col = int(row[lm_jacobian.IC_JJ]) + (k * nv + l) * nb
                    jj_lists.setdefault(ids[k] * n + ids[l], []).append(col)
                    jj_cols.append(col)
            g += 1
    assert sorted(jj_cols) == list(range(n_jj)) and sorted(jr_cols) == list(range(n_jr))
    for (entries, gather, _size), lists, zero in zip(system._assembly, (jj_lists, jr_lists),
                                                     (n_jj, n_jr)):
        assert entries.tolist() == sorted(lists)
        for e, cols in zip(entries.tolist(), gather.tolist()):
            assert cols == lists[e] + [zero] * (len(cols) - len(lists[e]))
    assert n_deg == sum(b.idx.shape[0] for b in system.blocks if b.spec.can_degenerate)
    if name == "every_kind":
        twice = [row for row in inst if row[lm_jacobian.IC_IDS] == row[lm_jacobian.IC_IDS + 1]]
        assert len(twice) == sum(b.spec.nvars > 1 for b in system.blocks)


def _before(system, x, pars=None, rhs=None, band=None):
    """``normal_equations`` as it was written before ``ops.lm_jacobian``
    (copies from the host each call)."""
    x = x.to(system.dtype)
    n = x.shape[0]
    parts, jj, jr = [], [], []
    deg_acc = torch.zeros((n, system.n_constraints), dtype=torch.int32)
    for i, (b, (lo, hi)) in enumerate(zip(system.blocks, system.block_row_slices())):
        spec = b.spec
        v = x[:, torch.as_tensor(b.idx, dtype=torch.long)]
        vs = tuple(v[..., k] for k in range(spec.nvars))
        p = torch.as_tensor(b.par, dtype=system.dtype) if pars is None else pars[i]
        ps = [p[..., k] for k in range(spec.nparams)]
        w = torch.as_tensor(b.weight, dtype=system.dtype)
        one, zero = torch.ones_like(vs[0]), torch.zeros_like(vs[0])
        wjac = []
        for a in range(spec.nvars):
            tangent = tuple(one if r == a else zero for r in range(spec.nvars))
            res, dres, deg = torch.func.jvp(lambda *vv, fn=spec.fn: fn(vv, ps), vs, tangent,
                                            has_aux=True)
            wjac.append([dres[d] * w for d in range(spec.dim)])
        if rhs is None:
            wres = [res[d] * w for d in range(spec.dim)]
        else:
            r_b = rhs[:, lo:hi].to(system.dtype).reshape(n, -1, spec.dim)
            wres = [r_b[..., d] for d in range(spec.dim)]
        for ka in wjac:
            jr.append(lm_jacobian.dot(ka, wres))
            jj.extend(lm_jacobian.dot(ka, la) for la in wjac)
        parts.append(torch.stack(wres, dim=-1).reshape(n, -1))
        if spec.can_degenerate:
            deg_acc.index_add_(-1, torch.as_tensor(b.cid, dtype=torch.long),
                               deg.to(torch.int32))
    if band is not None:
        entries, gather, _f, _i = band.tables(x.device)
        jj_plan = (entries, gather, system.n_vars * (band.bw + 1))
    else:
        jj_plan = system._assembly[0]
    sums = [gather_sum(torch.cat(vals, dim=1), torch.as_tensor(e), torch.as_tensor(g), size)
            for vals, (e, g, size) in ((jj, jj_plan), (jr, system._assembly[1]))]
    return torch.cat(parts, dim=-1), sums[0], sums[1], deg_acc > 0


CASES = [("rect_chain(8)", "dense"), ("rect_chain(8)", "band"), ("every_kind", "dense"),
         ("every_kind", "parts")]


@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,route", CASES)
def test_normal_equations_as_before(name, route, dtype, with_rhs):
    system = _system(name)
    if route == "parts":
        # Every instance inside one part of 24 variables: JtJ in one
        # diagonal block, the ``part_size`` plan.
        system = dataclasses.replace(system, part_size=system.n_vars)
    system = system.astype(dtype)
    band = _pick_spd(system) if route == "band" else None
    assert band is None or isinstance(band, banded.BandRoute)
    rng = np.random.default_rng(len(name) + with_rhs)
    x = torch.as_tensor(rng.uniform(-5.0, 5.0, (B, system.n_vars)))
    if name == "every_kind":
        x[1] = 0.25  # every point coincides: the degenerate branches
    pars = None
    if name.startswith("rect_chain"):
        pars = tuple(torch.as_tensor(b.par * rng.uniform(0.8, 1.25, (B,) + b.par.shape),
                                     dtype=dtype) for b in system.blocks)
    rhs = torch.as_tensor(rng.normal(0.0, 1.0, (B, system.n_rows))) if with_rhs else None
    jac, launches = tracing.counts().get("lm.jac_kernel", 0), lm_jacobian.LAUNCHES
    got = system.normal_equations(x, pars, rhs=rhs, band=band)
    want = _before(system, x, pars, rhs=rhs, band=band)
    assert got[1].shape[0] == B and got[1].numel() == want[1].numel()
    for g, w, what in zip(got, want, ("r", "jtj", "jtr", "deg")):
        assert g.dtype == w.dtype, what
        assert torch.equal(g.reshape(w.shape), w), what
    if name == "every_kind":
        assert bool(got[3][1].any()) and not bool(got[3][0].all())
    assert tracing.counts().get("lm.jac_kernel", 0) == jac and lm_jacobian.LAUNCHES == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_wider_rhs_gives_its_first_rows(dtype):
    system = _system("rect_chain(8)").astype(dtype)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(-5.0, 5.0, (B, system.n_vars)))
    rhs = torch.as_tensor(rng.normal(0.0, 1.0, (B, system.n_rows + 5)))
    got = system.normal_equations(x, rhs=rhs)
    want = system.normal_equations(x, rhs=rhs[:, :system.n_rows].clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (B, system.n_rows)


def test_tables_are_made_once_a_device():
    system = _system("rect_chain(8)").astype(torch.float32)
    x = torch.zeros((2, system.n_vars), dtype=torch.float32)
    before = tracing.counts().get("h2d.copies", 0)
    system.normal_equations(x)
    first = system.tables(x.device)
    system.normal_equations(x)
    assert system.tables(x.device) is first
    # Once: the tables (the Jacobian's 4, the instances' constraint ids,
    # the rows' weights and constraint ids) and the dense JtJ and Jtr
    # plans' entries and gathers (2 + 2).
    assert tracing.counts()["h2d.copies"] - before == 7 + 2 + 2
    assert first.n_rows == system.n_rows


def test_products_refuse_an_unsupported_device():
    system = _system("rect_chain(8)").astype(torch.float32)
    t = system.tables(torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        lm_jacobian.products(t, torch.zeros((1, system.n_vars), device="meta"))
