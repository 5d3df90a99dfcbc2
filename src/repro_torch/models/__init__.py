"""The model stack of the port (dense GQA family)."""
