"""Progress lines on standard error, stamped with the process's age."""
import sys
import time

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - _T0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)
