from xclip_tpu_torch.tokenizer.bpe import (  # noqa: F401
    DEFAULT_CONTEXT_LENGTH,
    SimpleTokenizer,
    get_tokenizer,
    tokenize,
)
