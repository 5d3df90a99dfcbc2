"""Model architectures and input shapes: a plain-Python copy of the
reference package's ``configs`` (same dataclasses, same values), kept
here because the port imports nothing of the reference."""
