# binquant_tpu — single-container deployment (reference Dockerfile parity:
# one process, heartbeat healthcheck, SIGTERM stop). Deps come from
# pyproject.toml (single source of truth). The default build installs CPU
# jax (container smoke / non-TPU hosts); build with --build-arg EXTRAS=tpu
# on a TPU VM to pull libtpu.
FROM python:3.12-slim

WORKDIR /app
ARG EXTRAS=""

COPY pyproject.toml README.md ./
COPY binquant_tpu ./binquant_tpu
COPY binquant_tpu_torch ./binquant_tpu_torch
RUN pip install --no-cache-dir ".${EXTRAS:+[$EXTRAS]}"

COPY main.py healthcheck.py bench.py __graft_entry__.py ./

HEALTHCHECK --interval=60s --timeout=10s --retries=3 \
    CMD ["python", "healthcheck.py"]

STOPSIGNAL SIGTERM
CMD ["python", "main.py"]
