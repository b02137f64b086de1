# chiaroscuro_tpu build/test/bench entry points (reference: Makefile:1-56,
# which only built the C++ binary; here native parts build on demand).

.PHONY: all native test test-fast bench clean

all: native

native:
	sh chiaroscuro_tpu/native/build.sh

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -x -m "not slow"

bench:
	python bench.py

clean:
	rm -f chiaroscuro_tpu/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
