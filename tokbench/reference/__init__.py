"""The plain reference that decides ``correct``: pre-split scanners and the
byte-pair merge in Python and NumPy. It reads the ``.tiktoken`` rank files
by path and imports nothing of the program."""

from .bpe import Reference, load_ranks, merge

__all__ = ["Reference", "load_ranks", "merge"]
