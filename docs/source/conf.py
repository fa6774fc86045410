"""Sphinx configuration for the rtgs_tpu docs site.

Same stack as the reference docs (Sphinx + MyST markdown + furo theme,
reference ``docs/source/conf.py:18-50``); built and deployed to GitHub Pages
by ``.github/workflows/build_deploy_docs.yml``.
"""

import os
import sys

sys.path.insert(0, os.path.abspath("../.."))

project = "rtgs_tpu"
author = "rtgs_tpu developers"
copyright = "2026, rtgs_tpu developers"

extensions = [
    "myst_parser",
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

myst_enable_extensions = ["dollarmath", "colon_fence"]

source_suffix = {".md": "markdown", ".rst": "restructuredtext"}
master_doc = "index"
exclude_patterns = []

html_theme = "furo"
html_title = "rtgs_tpu — differentiable ray-traced Gaussian splatting"

# Heavy accelerator deps may be absent on the docs builder.
autodoc_mock_imports = ["jax", "jaxlib", "optax", "chex"]
