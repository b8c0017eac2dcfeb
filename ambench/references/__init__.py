"""Plain references, one module each, named by a configuration's
``"reference"`` key.  They import nothing of ``repro_torch``."""
