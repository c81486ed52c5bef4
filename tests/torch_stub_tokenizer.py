"""The offline stub tokenizer of the port's tests, in a module that imports
neither JAX nor torch, so that the rank processes of the multi-device tests
(tests/torch_parallel_worker.py) can use it.  Not a test file."""


class StubTokenizer:
    """Offline tokenizer with encode/decode: one id per character, Llama-3
    and ChatML specials mapped to fixed ids inside a 512-token vocabulary."""

    SPECIALS = {"<|begin_of_text|>": 300, "<|start_header_id|>": 301, "<|end_header_id|>": 302,
                "<|eot_id|>": 303, "<|im_start|>": 304, "<|im_end|>": 305}

    def encode(self, text):
        ids, i = [], 0
        while i < len(text):
            for s, sid in self.SPECIALS.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    break
            else:
                ids.append(2 + ord(text[i]) % 250)
                i += 1
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)
