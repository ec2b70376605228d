"""The harness's general parts: finding a cell's files by name, statistics,
and the reading of a profiler trace."""
