"""Hold two accelsearch -wmax outputs of one spectrum against each other.

``jerk_file_agreement`` compares a ``_JERK_`` ACCEL table and .cand with
another written from the same spectrum: the card's against the CPU's, or
the port's against the JAX package's.  It reads the two refinements'
traces (``accelsearch.run`` returns one) and judges every line that
differs by ``search/polish.agreement``.  The CLI does not use it;
chip_smoke.py and the tests do.
"""

from __future__ import annotations

from presto_tpu_torch.apps.accelsearch import RefineTrace, read_cand_file
from presto_tpu_torch.search import polish


def _passed(rep: dict, n: int) -> set:
    """The indices of ``n`` candidates that ``rep`` (polish.agreement's
    report) holds: on the same point, moved within the rule, or on a tie
    path (whose flag stands, but which is the known near-tie fault, not
    a disagreement)."""
    if any(f["i"] == -1 for f in rep["flags"]):
        return set()
    return set(range(n)) - {f["i"] for f in rep["flags"]
                            if not f.get("tie_path")}


def jerk_polish_agreement(amps, want: RefineTrace, got: RefineTrace,
                          harmpolish: bool = True) -> dict:
    """The two sides' jerk polishes held by polish.agreement (jerk=True).
    From the same jerk seeds (the (r, z) polish agreed on every point),
    the two lists are held against each other.  Else each side's list is
    held against the port's CPU polish (optimize_jerk_cands) of that
    side's own seeds.  Returns {"reports": [...], "passed": the indices
    every report holds, "repolished": bool}."""
    pt = lambda c: (c.numharm, c.r, c.z, c.w)    # noqa: E731
    n = len(want.jseeds)
    if [pt(c) for c in want.jseeds] == [pt(c) for c in got.jseeds]:
        reps = [polish.agreement(amps, want.jocs, got.jocs,
                                 seeds=want.jseeds, jerk=True,
                                 harmpolish=harmpolish,
                                 numindep=want.numindep)]
        again = False
    else:
        reps = []
        for side in (want, got):
            # (the jerk polish computes no props: it does not read T)
            ref = polish.optimize_jerk_cands(
                amps, side.jseeds, 0.0, side.numindep, harmpolish=harmpolish,
                device="cpu")
            reps.append(polish.agreement(amps, ref, side.jocs,
                                         seeds=side.jseeds, jerk=True,
                                         harmpolish=harmpolish,
                                         numindep=side.numindep))
        again = True
    ok = set(range(n))
    for rep in reps:
        ok &= _passed(rep, n)
    return dict(reports=reps, passed=ok, repolished=again)


def jerk_file_agreement(amps, want_base: str, got_base: str,
                        want: RefineTrace, got: RefineTrace,
                        harmpolish: bool = True) -> dict:
    """Hold one _JERK_ ACCEL table and .cand (``got_base``, written from
    the refinement ``got``) against another (``want_base``, ``want``) of
    the same spectrum ``amps``, lobin 0: the same search seeds, candidate
    count and harmonics; each candidate on the same (r, z, w) grid point
    with its .cand power and sigma within polish.SAME_POWER_RTOL /
    SAME_SIGMA (its r, z and w are the same bytes) and its table line
    byte-equal, or differing only where a sigma or power column's two
    values straddle a %.2f rounding boundary (named, not failed).  Each
    other line is explained when its seed's (r, z) polish agrees by
    search/polish.agreement (the same point, a move within the rule, or
    a tie path), its jerk polish agrees (jerk_polish_agreement), and the
    two sides took the same polish's point or their choice between the
    two is a near-tie (the two polishes' powers within 2 JERK_EVAL_RTOL).
    Returns {"ok", "same", "boundary", "explained", "unexplained", "z",
    "jerk"} with the (r, z) agreement's report and the jerk polish's."""
    out = dict(ok=False, same=0, boundary=0, explained=0, unexplained=[])
    files = [read_cand_file(b + ".cand") for b in (want_base, got_base)]
    with open(want_base) as fa, open(got_base) as fb:
        lines = [fa.read().splitlines(), fb.read().splitlines()]
    pt = lambda c: (c.numharm, c.r, c.z, c.w)    # noqa: E731
    for tr, fl in zip((want, got), files):
        if [pt(c) for c in tr.final] != [pt(c) for c in fl]:
            out["unexplained"].append("a .cand differs from its trace")
    if [pt(c) for c in want.cands] != [pt(c) for c in got.cands]:
        out["unexplained"].append("the two searches' seeds differ")
    if (len(files[0]) != len(files[1]) or lines[0][:3] != lines[1][:3]
            or len(lines[0]) != len(lines[1])):
        out["unexplained"].append("lengths or headers differ")
    if out["unexplained"]:
        return out
    zrep = polish.agreement(amps, want.ocs, got.ocs, seeds=want.cands,
                            harmpolish=harmpolish)
    jrep = jerk_polish_agreement(amps, want, got, harmpolish)
    out.update(z=zrep, jerk=jrep)
    z_ok = _passed(zrep, len(want.cands))
    for i, (a, b) in enumerate(zip(*files)):
        la, lb = lines[0][3 + i], lines[1][3 + i]
        if pt(a) == pt(b):
            out["same"] += 1
            if (abs(a.power - b.power) > polish.SAME_POWER_RTOL * abs(a.power)
                    or abs(a.sigma - b.sigma) > polish.SAME_SIGMA):
                out["unexplained"].append("line %d: power or sigma"
                                          % (i + 1))
            elif la != lb:
                ta, tb = la.split(), lb.split()
                diff = [k for k, (x, y) in enumerate(zip(ta, tb)) if x != y]
                if (len(ta) == len(tb) and set(diff) <= {1, 2, 3}
                        and all(abs(float(ta[k]) - float(tb[k])) <= 0.0100001
                                for k in diff)):
                    out["boundary"] += 1
                else:
                    out["unexplained"].append("line %d" % (i + 1))
            continue
        k = want.seed_of[i]
        if got.seed_of[i] != k or a.numharm != b.numharm:
            out["unexplained"].append("line %d: another seed" % (i + 1))
            continue
        choice = (want.jerk_taken[i] == got.jerk_taken[i] or any(
            abs(j.power - o.power) <= 2 * polish.JERK_EVAL_RTOL * abs(o.power)
            for j, o in ((want.jocs[k], want.ocs[k]),
                         (got.jocs[k], got.ocs[k]))))
        if k in z_ok and k in jrep["passed"] and choice:
            out["explained"] += 1
        else:
            out["unexplained"].append("line %d: moved" % (i + 1))
    out["ok"] = not out["unexplained"]
    return out
