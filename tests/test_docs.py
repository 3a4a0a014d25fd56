"""Generated-API-reference smoke test (analog of the reference's Doxygen
build target, CMakeLists.txt:24-47)."""

import runpy
import sys
from pathlib import Path


def test_api_docs_generate(tmp_path):
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "docs"))
    mod = runpy.run_path(str(root / "docs" / "gen_api.py"))
    out = mod["main"](tmp_path)
    index = (out / "index.md").read_text()
    assert "SVGD" in index and "GaussianRBFKernel" in index

    driver = (out / "svgdcpp_jax_svgd.md").read_text()
    for sym in ("SVGDOptions", "class `SVGD", "update_kernel_parameters"):
        assert sym in driver, sym
    # CamelCase parity surface collapses into alias notes
    assert "CamelCase parity aliases" in driver

    sharded = (out / "svgdcpp_jax_parallel_sharded.md").read_text()
    for sym in ("ShardedSVGD", "run_state", "ShardedSVGDConfig"):
        assert sym in sharded, sym

    # every configured module produced a page with real content
    pages = list(out.glob("*.md"))
    assert len(pages) >= 25
    assert all(p.stat().st_size > 200 for p in pages)
