"""Meshes, abstract inputs, the dry run and its H100 roofline (the
counterpart of ``repro.launch``)."""
