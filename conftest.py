"""Hooks for the whole test tree.

``squeeze_bench/tests/test_sqb_metrics.py`` holds ``EXPECT``, every
per-layer reader's answer on a synthetic run, and checks that each metric of
``BENCHMARK.json`` has one.  Readers added beside it keep their answers in a
file of their own; their tables join ``EXPECT`` here, after collection, so
that the check sees them whichever files were collected."""
import importlib

# modules whose ``EXPECT`` joins the metric readers' table
READER_TABLES = ("squeeze_bench.tests.test_sqb_span_metrics",)


def pytest_collection_modifyitems(items):
    tables = {getattr(item, "module", None) for item in items}
    for mod in tables:
        if mod is not None and mod.__name__.endswith("test_sqb_metrics"):
            for name in READER_TABLES:
                mod.EXPECT.update(importlib.import_module(name).EXPECT)
