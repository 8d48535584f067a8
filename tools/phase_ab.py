"""Parent and change on one card in one call: phases 5, 6 and 6b of each
tree's own ``chip_smoke.py``, each run in a process of its own, in turns
(parent, change, change, parent).

    git archive <parent> | tar -x -C build/parent
    python3 tools/phase_ab.py build/parent [OUT_DIR]

Run from the root of the change's checkout on a machine with the card;
each run's output goes to ``OUT_DIR/ab_<i>_<parent|change>.log`` (default
``build/ab``); its LM prefill, serving and decode-step lines are the
readings to compare.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

CODE = ("import sys; sys.path[:0] = ['src', '.']; import torch, chip_smoke as C; "
        "torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False; "
        "C.phase_build(); C.phase_lm(torch, {'flash_attention': {}})")


def main() -> None:
    parent = sys.argv[1]
    out_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join("build", "ab")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    os.makedirs(out_dir, exist_ok=True)
    for i, tree in enumerate([parent, ".", ".", parent]):
        name = "parent" if tree == parent else "change"
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree, env=env,
                             capture_output=True, text=True)
        with open(os.path.join(out_dir, f"ab_{i}_{name}.log"), "w") as f:
            f.write(out.stdout + out.stderr)
        print(f"run {i} {name}: rc {out.returncode}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        if out.returncode:
            print(out.stderr[-3000:])
            sys.exit(1)


if __name__ == "__main__":
    main()
