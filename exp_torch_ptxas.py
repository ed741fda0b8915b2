"""Registers and spills of every instantiation of the epoch kernels
(``csrc/sgd_epoch.cu``, ``bpr_epoch.cu``, ``svdpp_epoch.cu``), as ptxas
reports them (``-Xptxas -v``, in ``ops/_build.py``'s flags).

    python3 exp_torch_ptxas.py [ROOT ...]

For each ROOT (default: this checkout; a parent unpacked beside it can be
named too) a child process builds that tree's kernels with its own
``load_library`` and the script prints, for each entry function whose
name holds ``epoch_kernel`` or ``walk_kernel``, its template arguments
(V, SPW, G, then the flags: kShared for SVD++, kOne where the tree has
it), registers, stack frame and spill stores and loads, one line ``PTXAS
{json}`` a tree. Needs nvcc (the card's machine).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

CHILD = ("from mymedialite_tpu_torch.ops._build import load_library; "
         "print(load_library().compiler_log)")
ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")
KERNEL = re.compile(r"\d+((?:sgd|svdpp)_epoch_kernel|bpr_walk_kernel)I(.*?)EEv")
TARG = re.compile(r"L([ib])(\d+)E")


def parse(log: str):
    """[{kernel, args, registers, stack, spill_stores, spill_loads}] of
    the epoch kernels' entry functions in a ptxas log."""
    out, cur = [], None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            k = KERNEL.search(m.group(1))
            cur = None
            if k:
                cur = dict(kernel=k.group(1),
                           args=[int(v) for _, v in TARG.findall(k.group(2))])
                out.append(cur)
            continue
        if cur is None:
            continue
        m = PROPS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def main(argv) -> int:
    roots = [os.path.abspath(r) for r in argv] or \
        [os.path.dirname(os.path.abspath(__file__))]
    rc = 0
    for root in roots:
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run([sys.executable, "-c", CHILD], env=env,
                             capture_output=True, text=True, cwd=root)
        rows = parse(res.stdout)
        if res.returncode or not rows:
            rc = 1
        print("PTXAS " + json.dumps(dict(root=root, kernels=rows,
                                         error=res.stderr[-2000:]
                                         if res.returncode else None)),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
