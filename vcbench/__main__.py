import time

STARTED = time.perf_counter()  # the set-up clock starts before torch is imported

if __name__ == "__main__":
    import sys

    from vcbench.run import main

    sys.exit(main(sys.argv[1:], started=STARTED))
