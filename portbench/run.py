"""The port's benchmark: one cell of BENCHMARK.json on this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints diagnostics and the compared
numbers on standard error and the result as the last line of standard
output; exits non-zero, with no result, where CUDA is missing or the run
fails.  The program runs at its defaults: every ``BLIT_*`` variable is
taken out of the environment first.
"""

import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
for _k in [k for k in os.environ if k.startswith("BLIT_")]:
    del os.environ[_k]
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".portbench_cache",
                                                  "torch_extensions")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
