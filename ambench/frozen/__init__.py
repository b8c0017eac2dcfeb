"""Frozen copies of arithmetic from the program, so that a later change to
the program cannot move the benchmark's yardstick.  Each module names the
file it was copied from."""
