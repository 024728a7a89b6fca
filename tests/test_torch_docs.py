"""The port's API docs: ``gpu_se_tpu_torch/api.rst`` lists every public
module of ``gpu_se_tpu_torch`` (no part of its path starting with ``_``),
and each renders through the reference's fallback renderer,
``docs/build.render_module`` (there is no Sphinx here), into a page with
its docstring and members. ``docs/`` itself is the reference's and lists
only ``gpu_se_tpu``."""
import html
import os
import pathlib
import re
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gpu_se_tpu_torch"
PAGES = PKG / "api.rst"
sys.path.insert(0, str(REPO / "docs"))


def page_list():
    return re.findall(r"^\.\. automodule:: (\S+)", PAGES.read_text(), re.M)


def public_modules():
    mods = set()
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__" or any(p.startswith("_") for p in parts):
            continue
        mods.add(".".join(parts))
    return mods


def test_page_list_covers_every_public_module():
    listed = page_list()
    assert len(listed) == len(set(listed))
    assert set(listed) == public_modules()


@pytest.mark.parametrize("modname", sorted(public_modules()))
def test_module_page_renders(modname, tmp_path):
    import build as docs_build

    body = docs_build.render_module(modname)
    page = tmp_path / (modname.replace(".", "_") + ".html")
    page.write_text(f"<html><body>{body}</body></html>")
    assert page.stat().st_size > 200, modname
    assert f"<h1><code>{html.escape(modname)}</code></h1>" in body
    # every module of the port carries a docstring
    mod = sys.modules[modname]
    assert mod.__doc__ and mod.__doc__.strip(), modname
    assert os.path.exists(page)
