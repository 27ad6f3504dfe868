"""Framework-free data helpers: the byte-level tokenizer."""
