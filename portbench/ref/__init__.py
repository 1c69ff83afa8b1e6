"""The plain reference: NumPy and plain PyTorch, no kernel, nothing of the
program.  ``model/`` and ``sim.py`` are frozen copies of the sweep model
and the simulator, ``windows.py`` of the window geometry and
``stream.py`` of the block-permutation stream; ``stat.py`` computes the
statistics the program reports."""
