"""Entry point: `python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (see
`harness.py`).  The clock of `setup_s` starts here, before any import."""

import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import sys

    from portbench.harness import main

    sys.exit(main(t_start=T0))
