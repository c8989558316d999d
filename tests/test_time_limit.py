"""The time limit and the slow list of the repo's root conftest.py, run on
an inner session whose own conftest loads the root one with the limit
lowered to 1 s."""

from pathlib import Path

pytest_plugins = ["pytester"]

CONFTEST = Path(__file__).resolve().parent.parent / "conftest.py"


def _inner_conftest(slow):
    return f"""
import importlib.util

spec = importlib.util.spec_from_file_location("suite_limits", {str(CONFTEST)!r})
suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(suite)
suite.TIME_LIMIT = 1
suite.SLOW = {slow!r}
globals().update(
    {{k: v for k, v in vars(suite).items() if k.startswith("pytest_")}}
)
"""


def test_a_test_past_the_limit_fails_and_the_next_runs(pytester):
    pytester.makeconftest(_inner_conftest(set()))
    pytester.makepyfile(
        test_inner="""
import time

import pytest


@pytest.fixture
def sleeps_in_setup():
    time.sleep(60)


def test_sleeps_past_the_limit():
    time.sleep(60)


def test_setup_sleeps_past_the_limit(sleeps_in_setup):
    pass


def test_next():
    pass
"""
    )
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(failed=1, errors=1, passed=1)
    result.stdout.fnmatch_lines(
        [
            "*Failed: test exceeded the 1 s time limit",
            "FAILED *::test_sleeps_past_the_limit*",
            "ERROR *::test_setup_sleeps_past_the_limit*",
        ]
    )
    assert result.duration < 60


def test_listed_tests_are_slow_and_have_no_limit(pytester):
    pytester.makeconftest(_inner_conftest({"test_inner.py::test_listed"}))
    pytester.makepyfile(
        test_inner="""
import time


def test_listed():
    time.sleep(2)


def test_other():
    pass
"""
    )
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(passed=2)
    result = pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-m", "not slow"
    )
    result.assert_outcomes(passed=1, deselected=1)
