"""The serving engine's device programs (counterpart of
``gym_tpu/programs/serve_defs.py``'s builders).

Each ``build_*`` returns a plain PyTorch function of device tensors with
the JAX builder's arguments: the bucketed prefill, the admit scatter, the
fused ``decode_chunk`` loop, and the paged family (prefix-aware paged
prefill, copy-on-write page copy, paged decode, fused draft-and-verify
speculative decode). The caches are updated in place where the JAX
programs donate them, and a function returns only what the host reads.

Every input that varies from call to call is a device tensor, never a host
scalar (the prefill's true length, the admitted slot, the copy-on-write
pages), and no function reads anything back to the host: each is one
``programs.graphs.StagedProgram``, which stages its inputs in one copy and,
on the card, captures it as a CUDA graph. The engine's ``warmup_defs``
names the family for the registry.

A decode chunk keeps the slots' lifecycle on the device (active, remaining,
EOS, the latched NaN quarantine): its ``chunk`` steps read nothing back to
the host, and their keys are folded on the card from the slots' base keys
and step indices (``threefry.random_bits_rows``).
"""

from __future__ import annotations

import torch

from ..models.nanogpt import GPT, GPTConfig, sample_logits


def _col(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 1)


def build_prefill(cfg: GPTConfig, bucket: int):
    model = GPT(cfg)

    def prefill(params, row_cache, tokens, true_len, key, temp, top_k,
                top_p):
        """tokens [1, bucket] right-padded, ``true_len`` [1]; fills the
        single-row cache ``row_cache`` from position 0 and returns the
        sampled first token [1], at the true last prompt position with key
        index 0 of the request's schedule. The row's K/V past the bucket
        are left from an earlier prompt: nothing reads a position past a
        row's cursor."""
        pos = row_cache["pos"]
        pos.zero_()
        logits = model.decode(params, tokens, row_cache,
                              logits_at=true_len - 1)[:, 0]
        row_cache["pos"] = pos
        zero = torch.zeros(1, dtype=torch.int32, device=tokens.device)
        tok = sample_logits(logits, key, temp, top_k, top_p, zero)
        return (tok.to(torch.int32),)

    return prefill


def build_slot_admit(cfg: GPTConfig, num_slots: int):
    def admit(cache, row_cache, slot, true_len):
        """Copy the prefilled single-row cache into slot ``slot`` [1] and
        rewind its cursor to ``true_len`` [1] (the pad K/V past it stays,
        masked until decode overwrites it); returns the cursors."""
        idx = slot.long()
        for name, c in cache.items():
            if name == "pos":
                c.index_copy_(0, idx, true_len)
            else:
                c.index_copy_(0, idx, row_cache[name])
        return (cache["pos"],)

    return admit


def build_slot_decode(cfg: GPTConfig, num_slots: int, chunk: int):
    model = GPT(cfg)

    def decode(params, cache, tok, active, base_keys, gen_idx, remaining,
               eos, temp, top_k, top_p):
        """``chunk`` decode steps of the whole slot batch. Each step feeds
        every slot its current token and samples its next with its own key
        and sampling vectors; a slot that reaches EOS or its budget turns
        inactive and freezes (its token and cursor stop). Returns ``(toks
        [chunk, S], emitted [chunk, S], last_logits [S, V], final_tok,
        final_active)``; the cursors advance in place."""
        act, gidx, rem = active, gen_idx, remaining
        toks, emits = [], []
        lg = None
        pos = cache["pos"]
        for _ in range(chunk):
            lg = model.decode(params, tok[:, None], cache)[:, 0]
            pos.copy_(torch.where(act, cache["pos"], pos))
            cache["pos"] = pos
            nxt = sample_logits(lg, base_keys, temp, top_k, top_p, gidx)
            nxt = torch.where(act, nxt.to(torch.int32), tok)
            emits.append(act)
            gidx = torch.where(act, gidx + 1, gidx)
            rem = torch.where(act, rem - 1, rem)
            done = act & ((rem <= 0) | ((eos >= 0) & (nxt == eos)))
            toks.append(nxt)
            tok, act = nxt, act & ~done
        return (torch.stack(toks), torch.stack(emits), lg, tok, act)

    return decode


def build_paged_prefill(cfg: GPTConfig, bucket: int):
    model = GPT(cfg)

    def prefill(params, cache, bt_row, start, tokens, true_suffix, key,
                temp, top_k, top_p):
        """Prefix-aware paged prefill of the suffix the prefix cache could
        not supply: ``tokens`` [1, bucket] right-padded from position
        ``start`` [1], ``true_suffix`` [1] long, attending to the resident
        prefix through ``bt_row``; returns the first token [1] (key index
        0) sampled at the true last prompt position. The suffix K/V go
        into the pool in place."""
        logits = model.decode(params, tokens, cache, block_table=bt_row,
                              cache_pos=start,
                              logits_at=true_suffix - 1)[:, 0]
        zero = torch.zeros(1, dtype=torch.int32, device=tokens.device)
        tok = sample_logits(logits, key, temp, top_k, top_p, zero)
        return (tok.to(torch.int32),)

    return prefill


def build_cow(cfg: GPTConfig):
    """Copy page ``src`` [1] to ``dst`` [1] in every layer's K and V pool:
    the copy-on-write of a shared block that must be appended into."""

    def cow(cache, src, dst):
        s, d = src.long(), dst.long()
        for c in cache.values():
            c.index_copy_(0, d, c.index_select(0, s))
        return (dst,)

    return cow


def build_paged_decode(cfg: GPTConfig, num_slots: int, chunk: int):
    """The paged twin of the slot decode: K/V through each slot's block
    table, the cursor ``pos`` carried explicitly, inactive rows' tables
    pointed at the null page, and non-finite logits latched per step while
    a row is active (a finished row reads the null page afterwards, so the
    last step cannot witness a poison that struck mid-chunk)."""
    model = GPT(cfg)

    def decode(params, cache, bt, tok, active, pos, base_keys, gen_idx,
               remaining, eos, temp, top_k, top_p):
        act, gidx, rem = active, gen_idx, remaining
        nanc = torch.zeros_like(active)
        toks, emits = [], []
        lg = None
        for _ in range(chunk):
            bt_eff = torch.where(_col(act), bt, 0)
            lg = model.decode(params, tok[:, None], cache,
                              block_table=bt_eff, cache_pos=pos)[:, 0]
            nanc = nanc | (act & ~torch.isfinite(lg).all(dim=-1))
            nxt = sample_logits(lg, base_keys, temp, top_k, top_p, gidx)
            nxt = torch.where(act, nxt.to(torch.int32), tok)
            emits.append(act)
            pos = torch.where(act, pos + 1, pos)
            gidx = torch.where(act, gidx + 1, gidx)
            rem = torch.where(act, rem - 1, rem)
            done = act & ((rem <= 0) | ((eos >= 0) & (nxt == eos)))
            toks.append(nxt)
            tok, act = nxt, act & ~done
        return (torch.stack(toks), torch.stack(emits), lg, tok, act, pos,
                nanc)

    return decode


def _ngram_draft(hist, hist_len, tok, gamma: int):
    """n-gram (prompt-lookup) drafting: for each slot, the ``gamma`` tokens
    that followed the most recent earlier occurrence of its current bigram
    ``(hist[len-2], tok)``; no match (or no continuation) repeats ``tok``.
    Drafts only decide how many samples a step keeps, never which."""
    s, length = hist.shape
    dev = hist.device
    idx = torch.arange(length - 1, device=dev)
    a = torch.gather(hist, 1, torch.clamp(hist_len - 2, 0, length - 1)
                     .long()[:, None])[:, 0]
    m = (hist[:, :-1] == a[:, None]) & (hist[:, 1:] == tok[:, None])
    # strictly before the current bigram (which always matches itself)
    m = m & (idx[None, :] + 1 < hist_len[:, None] - 1)
    has = m.any(dim=1)
    j = torch.where(m, idx[None, :], -1).max(dim=1).values   # latest match
    dpos = j[:, None] + 2 + torch.arange(gamma, device=dev)[None, :]
    d = torch.gather(hist, 1, torch.clamp(dpos, 0, length - 1))
    ok = has[:, None] & (dpos < hist_len[:, None])
    return torch.where(ok, d, tok[:, None]).to(torch.int32)


def build_spec_decode(cfg: GPTConfig, num_slots: int, chunk: int,
                      gamma: int):
    """Self-drafting speculative decoding fused into the ``decode_chunk``
    loop: each step drafts ``gamma`` tokens a slot by n-gram lookup in its
    own history, scores ``[tok, d_1..d_γ]`` in one ``γ+1``-token model
    call, and accepts on the device. Position ``i`` is sampled from the
    true conditional with the request's own key ``fold_in(base,
    gen_idx + i)``; the draft only decides how many of those samples the
    step keeps (the leading matches plus one), so the stream equals the
    non-speculative engine's for every sampling configuration. Rejected
    drafts roll back by the cursor alone: their K/V sit past it in blocks
    the slot owns, masked until overwritten."""
    model = GPT(cfg)
    g1 = int(gamma) + 1

    def spec(params, cache, bt, hist, tok, active, pos, base_keys, gen_idx,
             remaining, eos, temp, top_k, top_p):
        dev = tok.device
        s = tok.shape[0]
        length = hist.shape[1]
        pidx = torch.arange(g1, device=dev)[None, :]
        rows = torch.arange(s, device=dev)
        act, gidx, rem = active, gen_idx, remaining
        nanc = torch.zeros_like(active)
        def per_pos(x):
            # each row g1 times in a row (repeat_interleave by a python int
            # may copy its count to the card: no copy may enter a capture)
            return x.unsqueeze(1).expand(x.shape[0], g1, *x.shape[1:]) \
                .reshape(x.shape[0] * g1, *x.shape[1:])

        keys = per_pos(base_keys)

        rtemp, rtop_k, rtop_p = per_pos(temp), per_pos(top_k), per_pos(top_p)
        toks, emits = [], []
        lg = None
        for _ in range(chunk):
            hist_len = pos + 1                  # prompt + emitted count
            drafts = _ngram_draft(hist, hist_len, tok, gamma)    # [S, γ]
            inp = torch.cat([tok[:, None], drafts], dim=1)
            bt_eff = torch.where(_col(act), bt, 0)
            logits = model.decode(params, inp, cache, block_table=bt_eff,
                                  cache_pos=pos)                 # [S, γ+1, V]
            # position 0 only: later positions may be NaN by the
            # out-of-window poison on drafts that are then rejected
            nanc = nanc | (act & ~torch.isfinite(logits[:, 0]).all(dim=-1))
            data = (gidx[:, None] + pidx).reshape(-1).to(torch.int32)
            sampled = sample_logits(logits.reshape(s * g1, -1), keys, rtemp,
                                    rtop_k, rtop_p, data)
            sampled = sampled.view(s, g1).to(torch.int32)
            match = (sampled[:, :gamma] == drafts).to(torch.int32)
            m = (torch.cumprod(match, dim=1).sum(dim=1) + 1).to(torch.int32)
            is_eos = (_col(eos) >= 0) & (sampled == _col(eos))
            eos_hit = is_eos & (pidx < _col(m))
            any_eos = eos_hit.any(dim=1)
            first = torch.argmax(eos_hit.to(torch.int32), dim=1) + 1
            m = torch.where(any_eos, first.to(torch.int32), m)
            m = torch.minimum(m, rem)           # the max-tokens cap
            m = torch.where(act, m, 0)
            emit = (pidx < _col(m)) & _col(act)                  # [S, γ+1]
            new_tok = torch.gather(sampled, 1,
                                   torch.clamp(m - 1, min=0).long()[:, None])
            new_tok = torch.where(act, new_tok[:, 0], tok)
            rem = rem - m
            done = act & ((rem <= 0) | any_eos)
            # the history grows by the emitted tokens, for the next drafts
            # (written through a copy padded by γ+1 columns, so no index
            # is clamped onto another)
            hpos = (hist_len[:, None] + pidx).long()
            ext = torch.cat([hist, hist.new_zeros(s, g1)], dim=1)
            cur = torch.gather(ext, 1, hpos)
            ext[rows[:, None], hpos] = torch.where(emit, sampled, cur)
            hist = ext[:, :length]
            lg = logits[:, 0]
            toks.append(sampled)
            emits.append(emit)
            tok, act = new_tok, act & ~done
            pos, gidx = pos + m, gidx + m
        return (torch.stack(toks), torch.stack(emits), lg, tok, act, pos,
                nanc)

    return spec
