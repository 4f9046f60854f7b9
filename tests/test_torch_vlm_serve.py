"""The port's ``vlm`` servers (reduced Llama-3.2-Vision) against the JAX
package's on the same prompts, on the CPU: the fp32 servers' tokens equal
(at two units), the bf16 server held by
:func:`_lm_parity.assert_bf16_server_rule` with the servers' zero
``extras`` in its forced chains, and ``serve.main``.  Both servers give
prefill zeros, as the reference's does, so the cross blocks add exactly 0
here; ``tests/test_torch_vlm.py`` holds the cross-attention itself with
the gates open and seeded patches."""

from _lm_parity import assert_bf16_server_rule, servers
from repro_torch.launch import serve

ARCH = "llama-3.2-vision-11b"


def test_fp32_server_gives_the_jax_servers_tokens():
    *_, jreqs, reqs = servers(ARCH, "float32", 0, n_layers=10)
    for got, want in zip(reqs, jreqs):
        assert got.generated == want.generated


def test_bf16_server_gives_the_jax_servers_tokens():
    """:func:`_lm_parity.assert_bf16_server_rule`, the servers' zero
    ``extras`` in the forced chains: fed the reference's tokens, the port's
    bf16 logits lie within the reference's own bf16-vs-fp32 distance, and
    greedy tokens part only at near ties."""
    assert_bf16_server_rule(ARCH)


def test_serve_main_serves_the_vlm_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3", "--slots", "2",
                       "--prompt-len", "12", "--gen-len", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert f"[serve] {ARCH} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
