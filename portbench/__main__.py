import time

T_START = time.perf_counter()  # the process's start, before torch loads

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], T_START))
