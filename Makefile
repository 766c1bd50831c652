.PHONY: test test-fast test-gpu smoke bench native clean help

help:  ## show this help
	@grep -E '^[a-z-]+:.*##' Makefile | awk -F ':.*## ' '{printf "%-12s %s\n", $$1, $$2}'

test:  ## run the full test suite (CPU x64, 8 virtual devices)
	python -m pytest tests/ -q

test-fast:  ## run the test suite, stop at first failure
	python -m pytest tests/ -x -q

test-gpu:  ## run the gpu-marked tests (on a machine with an NVIDIA GPU)
	python -m pytest tests/ -q -m gpu

smoke:  ## check the main path on one GPU in complex128
	python chip_smoke.py

bench:  ## run the benchmark on one GPU
	python bench.py

native:  ## (re)build the native host runtime
	g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread \
	    native/qprop_native.cpp -o quantumpropagators/_qprop_native.so

clean:  ## remove build artifacts and caches
	rm -rf quantumpropagators/_qprop_native.so .pytest_cache .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
