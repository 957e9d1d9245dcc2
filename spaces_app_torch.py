"""Hugging Face Spaces entry point of the PyTorch port (the counterpart
of spaces_app.py): Spaces launches this file and expects the server on
port 7860. The engine (``legal_rag_tpu_torch.retrieval.facade.
LegalEngine``) loads in the background on the CUDA card; /health reports
the loading -> ready transition."""

import asyncio
import logging
import os

os.environ.setdefault("PORT", "7860")

from legal_rag_tpu_torch.server.app import run_server  # noqa: E402

if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    asyncio.run(
        run_server(
            store_dir=os.environ.get("LEGAL_RAG_STORE", "data/vector_store"),
            port=int(os.environ["PORT"]),
        )
    )
