"""One driver a kind of work; a traffic mix names its driver.

A driver module defines ``Driver(cfg, traffic, seed, device)`` with:
``setup()`` (everything before the window, the checked training steps
included), ``window(seconds)`` (the timed work: its end-to-end values,
``attempted``, ``failed``), ``trace(profile)`` (a profiled slice and the
work it did, for the per-layer readers), ``release()`` (frees the
program's state once the window has closed), ``check()`` (the compared
numbers), ``control()`` (the same numbers with the reference in TF32 in
the program's place) and, for training, ``faults()``."""
