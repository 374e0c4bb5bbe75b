"""Lattice text serialization (the lattice ark format): a copy of
kaldi_tpu/lat/io.py, the latgen CLI's output format.

(ref: lat/kaldi-lattice.h Table holders :71-131 — the text Lattice format:
 one FST per utterance, lines `src dst ilabel olabel graph,acoustic` (plus
 final lines `state graph,acoustic`), utterances separated by blank lines,
 each preceded by its key.)
"""

from __future__ import annotations

from kaldi_tpu_torch.lat.lattice import Lattice


def write_lattice_text(f, key: str, lat: Lattice):
    f.write(f"{key}\n")
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            tids = getattr(a, "tids", None)
            suffix = ("," + "_".join(str(t) for t in tids)) if tids else ""
            f.write(f"{s} {a.nextstate} {a.ilabel} {a.olabel} "
                    f"{a.graph_cost:.6g},{a.acoustic_cost:.6g}{suffix}\n")
    for s, (g, ac) in lat.finals.items():
        f.write(f"{s} {g:.6g},{ac:.6g}\n")
    f.write("\n")


def write_lattice_ark(path: str, lattices: dict):
    with open(path, "w") as f:
        for key, lat in lattices.items():
            if lat is not None:
                write_lattice_text(f, key, lat)


def read_lattice_ark(path: str):
    """Yield (key, Lattice)."""
    with open(path) as f:
        key = None
        lat = None
        for raw in f:
            line = raw.strip()
            if not line:
                if key is not None and lat is not None:
                    yield key, lat
                key, lat = None, None
                continue
            parts = line.split()
            if key is None:
                # the first line of a block is always the utterance key
                # (numeric keys included — 'key is None' disambiguates)
                assert len(parts) == 1, f"expected key line, got: {line}"
                key = parts[0]
                lat = Lattice()
                lat.start = lat.add_state()
                continue
            assert lat is not None, f"lattice line before key: {line}"

            def ensure(s):
                while lat.num_states <= s:
                    lat.add_state()

            if len(parts) == 5:
                s, d, il, ol = (int(parts[0]), int(parts[1]),
                                int(parts[2]), int(parts[3]))
                fields = parts[4].split(",")
                g, a = float(fields[0]), float(fields[1])
                ensure(max(s, d))
                lat.add_arc(s, il, ol, g, a, d)
                if len(fields) > 2 and fields[2]:
                    lat.arcs[s][-1].tids = tuple(
                        int(t) for t in fields[2].split("_"))
            elif len(parts) == 2:
                s = int(parts[0])
                g, a = (float(x) for x in parts[1].split(","))
                ensure(s)
                lat.set_final(s, g, a)
            elif len(parts) == 1:
                # bare final state (zero weight)
                s = int(parts[0])
                ensure(s)
                lat.set_final(s)
        if key is not None and lat is not None:
            yield key, lat
