#!/bin/bash
# Deployment entry of the PyTorch port (the counterpart of start.sh):
# pre-flight checks, PORT defaulting, then the port's server on the card
# (LEGAL_RAG_DEVICE, default cuda; cpu serves without one), through the
# interpreter PYTHON (default python3).
set -u
echo "Starting legal_rag_tpu_torch pre-flight..."
echo "Current directory: $(pwd)"

STORE="${LEGAL_RAG_STORE:-data/vector_store}"
DEVICE="${LEGAL_RAG_DEVICE:-cuda}"
PYTHON="${PYTHON:-python3}"
if [ -d "$STORE" ]; then
    echo "Store directory contents:"
    ls -l "$STORE"
elif [ -n "${LEGAL_RAG_CORPUS:-}" ] && [ -d "$LEGAL_RAG_CORPUS" ]; then
    echo "No store at $STORE; building from corpus $LEGAL_RAG_CORPUS..."
    "$PYTHON" -m legal_rag_tpu_torch build --device "$DEVICE" \
        --source "$LEGAL_RAG_CORPUS" --store "$STORE" --finetune-steps 4000
else
    echo "WARNING: no store at $STORE and no LEGAL_RAG_CORPUS set;" \
         "serve will fail to load it"
fi

if [ -z "${PORT:-}" ]; then
    echo "PORT not set, defaulting to 10000"
    PORT=10000
fi
echo "Binding to PORT: $PORT on device $DEVICE"
exec env LEGAL_RAG_STORE="$STORE" PORT="$PORT" \
    "$PYTHON" -m legal_rag_tpu_torch serve --store "$STORE" --port "$PORT" \
    --device "$DEVICE"
