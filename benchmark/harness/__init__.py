"""The benchmark's harness: general code that finds each configuration,
traffic mix and metric by the name BENCHMARK.json gives it."""
