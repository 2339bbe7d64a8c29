"""Generate the committed real-format fixture files (run ONCE; outputs
are checked in under tests/fixtures/ — VERDICT r2 #6).

The zero-egress image cannot vendor the published G-set / SDPLIB files
themselves, so the fixtures are generated-once-and-committed files in
the same on-disk PROFILES the reference consumes
(/root/reference/src_semi/io/lorads_file_io.c:21-417 for .dat-s;
G-set rudy graphs, README.md:148-151):

* g_toy60.rudy        — rudy/G-set graph: "n m" header + 1-based
                        "i j w" edge lines, +/-1 weights.
* mc_gtoy60.dat-s     — Max-Cut SDP of that graph, entry order
                        SHUFFLED + comment lines + some upper-tri
                        entries, so the file is NOT a canonical
                        write_sdpa product (exercises the reader on a
                        file the repo didn't write).
* theta_gtoy60.dat-s  — Lovász theta SDP of the graph, same treatment.

hand_multiblock.dat-s is hand-authored (not generated) — it carries the
reader edge cases: '*'/'"' comments, braced dim list, LP block,
upper-triangle + duplicate + below-1e-12 entries.

Run:  JAX_PLATFORMS=cpu python tools/make_fixtures.py
"""

import os

import numpy as np

FIXDIR = os.path.join(os.path.dirname(__file__), "..", "tests",
                      "fixtures")


def _write_rudy(path, n, edges):
    lines = [f"{n} {len(edges)}"]
    lines += [f"{i + 1} {j + 1} {int(w)}" for i, j, w in edges]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _decanonicalize(path, seed, header):
    """Shuffle a write_sdpa file's entry lines, flip some entries to
    upper-triangle, and add comment lines — the result parses to the
    SAME problem but is no longer a file this repo's writer would
    emit."""
    rng = np.random.default_rng(seed)
    with open(path) as fh:
        lines = fh.read().splitlines()
    head, entries = lines[:4], lines[4:]
    rng.shuffle(entries)
    out = [f"* {header}",
           '" generated once by tools/make_fixtures.py and committed']
    out += head
    for k, line in enumerate(entries):
        parts = line.split()
        if len(parts) == 5 and parts[2] != parts[3] and k % 3 == 0:
            # store as upper triangle: the reader must normalize
            parts[2], parts[3] = parts[3], parts[2]
        out.append(" ".join(parts))
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def main():
    from lorads_tpu.io import generators
    from lorads_tpu.io.sdpa import write_sdpa

    os.makedirs(FIXDIR, exist_ok=True)
    rng = np.random.default_rng(60)
    n, n_e = 60, 180
    seen = set()
    edges = []
    while len(edges) < n_e:
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        edges.append((key[0], key[1], 1 if rng.random() < 0.7 else -1))
    gpath = os.path.join(FIXDIR, "g_toy60.rudy")
    _write_rudy(gpath, n, edges)

    mc = generators.maxcut_from_graph(gpath)
    mcpath = os.path.join(FIXDIR, "mc_gtoy60.dat-s")
    write_sdpa(mcpath, mc)
    _decanonicalize(mcpath, 1, "Max-Cut SDP of g_toy60.rudy "
                    "(G-set profile: min <-L/4,X>, X_ii=1)")

    th = generators.theta_from_graph(gpath)
    thpath = os.path.join(FIXDIR, "theta_gtoy60.dat-s")
    write_sdpa(thpath, th)
    _decanonicalize(thpath, 2, "Lovasz theta SDP of g_toy60.rudy "
                    "(SDPLIB theta profile)")
    print("wrote", gpath, mcpath, thpath)


if __name__ == "__main__":
    main()
