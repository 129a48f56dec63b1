"""Result files, the message bus and the vector store (port of
``lameness_tpu/io``)."""
