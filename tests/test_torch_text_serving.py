"""Text in / text out on the port's serving stack, against the JAX
package: the reference's ``test_http_text_in_text_out``
(``tests/test_lm_serving.py``) through the port's ``HttpFrontend(
tokenizer=...)`` in front of the port's ``ClusterServing``, on the
micro-batch path and on the continuous engine (paged), with the
reference's weights carried across (``params_from_flax``).

Its four cases: a ``text`` instance tokenizes into the prompt column
and its result decodes back to the string the reference's ``generate``
of the same ids decodes to; a ``tokens`` instance in the same batch
stays an array (the reference's tokens); text and tokens in one
instance is a 400; text without a tokenizer is a 400.  The tokenizer is
the reference test's ``_tiny_tokenizer`` (``tokenizers``' BPE, trained
in memory); the card's machine has no ``tokenizers``, so this stays a
CPU test.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import generate as jax_generate
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.lm import TransformerLM, params_from_flax
from analytics_zoo_tpu_torch.serving import (ClusterServing, HttpFrontend,
                                             ServingConfig)


def _tiny_tokenizer(vocab_target=48):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_target, special_tokens=["[UNK]", "[EOS]"])
    tok.train_from_iterator(
        ["the cat sat on the mat", "a dog ran fast", "cats and dogs"],
        trainer)
    return tok


def _post(port, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/predict", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro_batch", "engine"])
def test_http_text_in_text_out(continuous):
    tok = _tiny_tokenizer()
    V = tok.get_vocab_size()
    cfg = dict(vocab_size=V + 8, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_position=64)
    jm = JaxLM(dtype=jnp.float32, **cfg)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    model = TransformerLM(dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    im = InferenceModel().load_torch_generator(
        model, None, 5, prompt_buckets=(8, 16), device="cpu")
    scfg = ServingConfig(batch_size=8, batch_timeout_ms=30.0,
                         prompt_col="tokens", prompt_pad_id=0,
                         continuous_batching=continuous,
                         engine_paged=continuous, engine_block_size=4)
    srv = ClusterServing(im, scfg, embedded_broker=True).start()
    fe = fe2 = None
    try:
        fe = HttpFrontend(redis_port=srv.port, timeout=40, serving=srv,
                          tokenizer=tok).start()
        text = "the cat ran"
        ids = np.asarray(tok.encode(text).ids, np.int32)
        arr_prompt = np.asarray([3, 4, 5], np.int32)
        status, body = _post(fe.port, {"instances": [
            {"text": text}, {"tokens": arr_prompt.tolist()}]})
        assert status == 200, body
        preds = json.loads(body)["predictions"]
        solo = np.asarray(jax_generate(jm, variables,
                                       jnp.asarray(ids[None]), 5))[0]
        assert preds[0] == tok.decode(solo.astype(np.int64).tolist())
        solo2 = np.asarray(jax_generate(jm, variables,
                                        jnp.asarray(arr_prompt[None]), 5))[0]
        np.testing.assert_array_equal(np.asarray(preds[1], np.int32), solo2)
        # both text and tokens in one instance -> ambiguous, 400
        assert _post(fe.port, {"text": "hi", "tokens": [1, 2]},
                     timeout=30)[0] == 400
        # no tokenizer configured -> 400, not a backend error
        fe2 = HttpFrontend(redis_port=srv.port, timeout=10,
                           serving=srv).start()
        assert _post(fe2.port, {"text": "hi"}, timeout=30)[0] == 400
    finally:
        for f in (fe, fe2):
            if f is not None:
                f.stop()
        srv.stop()
