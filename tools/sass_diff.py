#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels between two checkouts.

    python3 tools/sass_diff.py OLD_SRC NEW_SRC NAME [NAME ...] [--dump DIR]

``OLD_SRC`` and ``NEW_SRC`` are the ``src`` directories of two checkouts of
this repository; each ``NAME`` is a source ``repro_torch/csrc/NAME.cu``
(for example ``fused_select`` and ``coord_select``).  Both versions of a
source are compiled by ``tools/sass_count.py --dump`` (the flags of
``repro_torch/kernels/build.py``); a kernel's SASS is its dumped
instruction listing, its name with the per-file hash of the anonymous
namespace taken out.  Prints one JSON object per source: the kernels of
each version, how many of the old ones are identical, which differ or are
missing, which are new.  Exits 1 when a kernel of ``OLD_SRC`` is not in
``NEW_SRC`` with the same SASS.  Needs ``nvcc`` and ``cuobjdump``.
"""
import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# the anonymous namespace's name: its two 8-digit hashes around the file's
# name; the <length><name> of what it holds follows and is kept
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def listings(root, name, dump):
    """{kernel name without the anonymous namespace's hash: SASS text};
    exits when two kernels' names become one."""
    os.makedirs(dump, exist_ok=True)
    src = os.path.join(root, "repro_torch", "csrc", f"{name}.cu")
    res = subprocess.run([sys.executable, os.path.join(HERE, "sass_count.py"),
                          src, "--dump", dump], capture_output=True,
                         text=True)
    if res.returncode != 0:
        sys.exit(f"sass_count.py failed on {src}:\n{res.stdout}{res.stderr}")
    out = {}
    for path in glob.glob(os.path.join(dump, "*.sass")):
        kernel = os.path.basename(path)[len("0_"):-len(".sass")]
        key = ANON.sub("ANON", kernel)
        if key in out:
            sys.exit(f"{src}: two kernels are named {key} without the "
                     f"anonymous namespace's hash")
        with open(path) as fh:
            out[key] = fh.read()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_src")
    ap.add_argument("new_src")
    ap.add_argument("names", nargs="+")
    ap.add_argument("--dump", default=None,
                    help="keep each version's SASS listings here")
    args = ap.parse_args()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        base = args.dump or tmp
        for name in args.names:
            old = listings(args.old_src, name, os.path.join(base, f"old_{name}"))
            new = listings(args.new_src, name, os.path.join(base, f"new_{name}"))
            differ = sorted(k for k, v in old.items() if new.get(k) != v)
            ok &= not differ
            print(json.dumps({"source": f"{name}.cu", "old_kernels": len(old),
                              "new_kernels": len(new),
                              "identical": len(old) - len(differ),
                              "differ_or_missing": differ,
                              "added": sorted(set(new) - set(old))}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
