"""Plain references, one file per model family (``cfg["family"]``), and
the admission layer's (``gate.py``). They import nothing of the program."""
