"""Scheduling of the test suite under pytest-xdist's ``--dist loadfile``.

``loadfile`` sends each test file to one worker whole, so a run cannot end
before its slowest file does. ``tests/test_data.py`` holds eager
``shard_map`` tests that take minutes each on the CPU (an eager
``shard_map`` call of ``augment.batched_tier`` costs ~150 s whatever the
mesh size), and on one worker that file alone came within 2% of the suite's
time limit. So each test of the files in ``SPLIT_FILES`` is a unit of its
own, the units in ``LONGEST_FIRST`` are sent out before any other, and every
other file still goes to one worker whole. Other ``--dist`` modes are left
as they are.
"""

import pytest

# Each test of these files is a scheduling unit of its own.
SPLIT_FILES = ("tests/test_data.py",)

# Sent out first, in this order, so that no worker starts one of them late.
# Seconds of each in a six-worker run of the whole suite.
LONGEST_FIRST = (
    "tests/test_data.py::TestShardedAugment::test_batched_tier_sharded_matches_unsharded",  # 720
    "tests/test_data.py::TestShardedAugment::test_model_axis_mesh_also_goes_pershard",  # 301
    "tests/test_data.py::TestAugment::test_random_d4_uniform_over_group",  # 131
    "tests/test_data.py::TestShardedAugment::test_batched_classification_sharded_matches_unsharded",  # 72
)


def unit_rank(scope):
    """Where a unit goes in the queue: lower first, None where xdist puts it."""
    if scope in LONGEST_FIRST:
        return LONGEST_FIRST.index(scope)
    if scope.split("::", 1)[0] in SPLIT_FILES:
        return len(LONGEST_FIRST)
    return None


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitLoadFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = super()._split_scope(nodeid)
            return nodeid if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            ranked = [s for s in self.workqueue if unit_rank(s) is not None]
            if ranked:
                # min keeps the queue's order among equal ranks.
                self.workqueue.move_to_end(min(ranked, key=unit_rank), last=False)
            super()._assign_work_unit(node)

    return SplitLoadFileScheduling(config, log)
