#!/usr/bin/env python3
"""Compare the SASS of the jagged attention kernels (K1-fwd, K2 and K8, in
``csrc/jagged_attn_fwd.cu`` and ``csrc/jagged_attn_bwd.cu``) between two
checkouts: every kernel of OLD against its counterpart in NEW, where NEW's
kernels carry one more template argument, the mask (CAUSAL, last), and its
causal instantiation (``true``) must be OLD's kernel instruction for
instruction. NEW's acausal instantiations are listed beside.

Usage (on a machine with nvcc and cuobjdump):

    python3 scripts/compare_attn_sass.py OLD_CHECKOUT NEW_CHECKOUT

Each checkout builds its two libraries with its own
``repro_torch.kernels._build`` (in a subprocess, into its own
``build/kernels/``; both checkouts' builds run side by side). Branch
labels are renumbered per function before the comparison; the encodings
are compared as they are. Prints one line per kernel and exits 1 if any
causal kernel differs or has no counterpart."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

SOURCES = ("jagged_attn_fwd", "jagged_attn_bwd")
_BUILD = ("import sys; sys.path.insert(0, 'src'); "
          "from repro_torch.kernels import _build; "
          "_build.build_all({names!r}); "
          "print('\\n'.join(str(_build.library_path(n)) for n in {names!r}))")


def build(root: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _BUILD.format(names=list(SOURCES))], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def kernels(lib: str, cuobjdump: str, cufilt: str) -> dict:
    """{(kernel name, template arguments): instruction lines} of a
    library, labels renumbered per function."""
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur, body, names = {}, None, [], []

    def close():
        if cur is not None:
            labels = {}
            norm = []
            for ln in body:
                for lab in re.findall(r"\.L_x_\d+", ln):
                    labels.setdefault(lab, f".L{len(labels)}")
                norm.append(re.sub(r"\.L_x_\d+", lambda m: labels[m.group()],
                                   ln))
            out[cur] = norm

    for ln in sass.splitlines():
        if "Function :" in ln:
            close()
            mangled = ln.split("Function :", 1)[1].strip()
            name = subprocess.run([cufilt, mangled], capture_output=True,
                                  text=True, check=True).stdout.strip()
            m = re.search(r"(\w+)<([^<>]*)>\(", name)
            cur = ((m.group(1), tuple(_arg(a) for a in
                                      m.group(2).split(",")))
                   if m else (name, ()))
            names.append(name)
            body = []
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            body.append(ln.strip())
        elif cur is not None and re.match(r"\s*\.L_x_\d+:", ln):
            body.append(ln.strip())
    close()
    print(f"[sass] {Path(lib).name}: {len(out)} functions, e.g. "
          f"{names[:1]}")
    return out


def _arg(a: str) -> str:
    """A template argument as cu++filt prints it, without a cast:
    "(bool)1" and "true" → "true", "(int)128" → "128"."""
    a = re.sub(r"^\((?:bool|int)\)", "", a.strip())
    return {"1": "true", "0": "false"}.get(a, a)   # no head dim is 0 or 1


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__)
        return 2
    old_root, new_root = Path(argv[1]).resolve(), Path(argv[2]).resolve()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    bindir = Path(nvcc).parent
    cuobjdump, cufilt = str(bindir / "cuobjdump"), str(bindir / "cu++filt")
    procs = {root: build(root) for root in (old_root, new_root)}
    libs = {}
    for root, p in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            print(f"[sass] build in {root} failed:\n{stderr[-4000:]}")
            return 1
        libs[root] = stdout.strip().splitlines()[-2:]
    bad = compared = 0
    for i, src in enumerate(SOURCES):
        old = kernels(libs[old_root][i], cuobjdump, cufilt)
        new = kernels(libs[new_root][i], cuobjdump, cufilt)
        acausal = []
        for (name, args), body in sorted(new.items()):
            if not args or args[-1] not in ("true", "false"):
                continue                  # not templated on the mask
            if args[-1] == "false":
                acausal.append(f"{name}<{', '.join(args)}>")
                continue
            want = old.get((name, args[:-1]))
            same = want == body
            bad += not same
            compared += 1
            print(f"[sass] {src} {name}<{', '.join(args)}>: "
                  f"{len(body)} lines; old <{', '.join(args[:-1])}> "
                  f"{'missing' if want is None else len(want)} lines; "
                  f"identical {same}")
        print(f"[sass] {src}: {len(acausal)} acausal kernels: "
              f"{', '.join(acausal)}")
    print(f"[sass] causal kernels compared {compared}, differing from the "
          f"old build: {bad}")
    return 1 if bad or not compared else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
