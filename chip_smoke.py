#!/usr/bin/env python3
"""On-card smoke test of lumen_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the cold build of all six CUDA libraries (the five kernels and the MoE
   grouped product; one ``nvcc`` per source, all started together, its
   seconds printed), with each kernel function's registers, shared
   memory and spills from ptxas (no 2-byte flash kernel and no paged
   kernel may spill) and its count of tensor-core instructions (HMMA)
   from ``cuobjdump -sass`` (the sixteen 2-byte flash kernels --
   flash_attention's short and long paths at head_dim 64, 16 and 128,
   and the cache kernel at 64 and 128, each in bf16 and fp16 -- and the
   paged walk's GQA path at 64 and 128 in both types must have some).
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same seeded inputs, at the serving path's shapes plus ragged cases
   (for the flash kernels: lengths and ``kv_valid`` on either side of the
   64-key tile, causal diagonals crossing a tile, two-row batches, the
   fp32 instance, phase 8's CLIP calls at the bulk batch of 64: the
   vision tower's [64, 12, 50, 64] and the causal text tower's
   [64, 8, 77, 64], and phase 10's native OCR recognizer at head_dim 16:
   [8, 4, 960, 16] and [32, 4, 1920, 16] in bf16, [2, 4, 240, 16] in fp32,
   causal cases, and head_dims 32/80 refused; the head_dim-128 instances
   of the Qwen2-MoE decoder at phase 15's shapes: flash causal
   [1, 16, 265, 128], the cache kernel's q [1, 16, 256, 128] against 832
   slots, paged q [8, 16, 128] at lengths 1..500, the verify window
   [8, 5, 16, 128], each with ragged and fp32 cases; and w8a16 at the
   MoE decoder's int8 shapes, K x N = 2048 x 2048, 2048 x 5632,
   5632 x 2048 and the lm_head's 2048 x 151936), with times for the
   kernel, the plain version, the
   card's bound and one PyTorch library call computing the same function
   (a yardstick only; the port never calls it). Each flash_attention shape
   of the kernel table prints the launch plan the library picked (read
   with ``lumen_flash_plan`` and held equal to ``ops.attention.flash_plan``)
   and its blocks resident an SM; a CLIP row's bits do not depend on the
   batch (1 of 64, bitwise). Times are device time per
   call from ``torch.profiler``, checked against lost events
   (``device_ms``); one w8a16 call is also timed with the host's launch
   path (CUDA events). The paged kernels are also checked at the edges of
   their 64-key span and on a 2048-token row, in both dtypes, and each
   paged row is timed twice: warm (one set of pages, K/V in the 50 MB L2)
   and from device memory (``paged_sets``: disjoint pages whose live K/V
   pass the L2, as a decode step's layers find them). Bitwise, the
   greedy identity of speculation leans on, at head_dim 64 and 128 in
   bf16 and fp32: verify slot t at W = 1, 5 and 16 equals the
   single-token kernel at kv_lens + t, a row alone equals the same row
   in the batch of 8, a paged row's output does not depend on its
   table's width (32 vs 128 pages), and w8a16 rows do not depend on the
   row count (8 of 40, 1 of 64). Each paged line prints the plan the
   library launches (``lumen_paged_plan``, held equal to
   ``ops.attention.paged_plan``: tensor cores or FMA units, query rows,
   KV heads and window slots a block, span, blocks, threads, shared
   memory, blocks resident an SM) and its workspace; no paged kernel may
   spill; each w8a16 shape prints its K split, blocks and ring. Then
   every float16 instance (``check_fp16``: flash <16>, <64>, <128>, the
   cache kernel, paged and verify at <64> and <128>) against its plain
   version with ragged cases, timed at the bf16 rows' shapes beside its
   bound and SDPA in float16, its paged plans equal to bf16's, the paged
   bitwise properties in float16 too; and the MoE grouped product in
   float16 and float32 (``check_grouped_mm``) against
   ``grouped_mm_reference`` at phase 15 (c)'s shapes, a 256-token chunk
   and a ragged case, with no device-to-host sync a call.
3. reference: a small fp32 VLM served on the card (kernels) and on the
   CPU (plain versions) gives the same greedy tokens, and so does the
   card with speculative decoding (``LUMEN_VLM_SPEC_K=4``).
4. serving path at full width: ``VLMConfig()`` (Qwen2-0.5B decoder +
   1024/64 ViT, seeded random weights, bf16) behind ``VLMManager`` on the
   paged continuous engine; concurrent caption requests, streaming and
   late-arriving ones included. Launch counts are zeroed just before and
   read just after: every kernel of the path must have run. Greedy
   determinism is checked by repeating a request.
5. the int8 speculative path at full width: phase 4 with
   ``quantize="int8"`` and ``LUMEN_VLM_SPEC_K=4`` on templated prompts;
   the w8a16 and verify-window kernels must run, verify turns must be
   taken, every decoder projection must hold int8 weights.
6. the main path as users reach it, at full width: a ``VLMConfig()``
   model directory (seeded bf16 weights under the HF/FastVLM names,
   ``config.json``, a WordLevel ``tokenizer.json`` of all 151936 ids, a
   chat template, ``model_info.json``) written to a temporary directory,
   served by the port's ``serve()`` (``lumen_tpu_torch/serving/server.py``)
   from a deployment YAML that names the service in its JAX form. Over
   real gRPC: 10 ``vlm_generate_stream`` requests, 8 in flight at once,
   each with its own 1600x1200 JPEG (decoded and letterboxed by the
   server), then ``vlm_generate``, ``GetCapabilities``, ``Health`` and a
   malformed image (``INVALID_ARGUMENT``). Request 0 must equal a
   ``VLMManager`` built directly from the same weights on the same canvas;
   the bf16 path's three kernels must have run. Then a second server with
   ``quantize: int8`` and ``LUMEN_VLM_SPEC_K=4`` answers 4 templated
   requests, which must launch the w8a16 and verify-window kernels.
7. the JAX server's default serving path: phase 6's model directory
   behind one bf16 ``serve()`` with the spill tier at its default, the
   result cache, breaker and quarantine, the metrics sidecar and a 64 MiB
   prefix cache (``LUMEN_VLM_PREFIX_BYTES``), on a KV pool pinned small
   enough that rows must preempt. Over gRPC: (a) 6 greedy and 2 sampled
   streams, which must preempt, spill and resume with no stream failed,
   the greedy answers equal to themselves rerun alone and to phase 6's;
   (b) one photo asked three questions, cold and then in two waves: prefix
   hits, fewer prefill chunks, equal answers, ``prefix_hit`` in the
   metadata; (c) a ``vlm_generate`` sent twice: the second ``cached``,
   equal, with no kernel launch; (d) ``/metrics.json`` lists the ``vlm_*``
   counters, the ``vlm-continuous:*`` gauges and the ``vlm.ttft``
   histogram, and ``Health`` carries ``lumen-breaker-status``. Then a
   spill round trip at the full-width pool shapes: export a row, resume
   it into another grant, export again: byte-equal payloads. The path's
   three kernels must run in (a)-(b).
8. CLIP embeddings and zero-shot labels as users reach them: a
   ``CLIPConfig()`` model directory (OpenAI ViT-B/32 shapes, seeded bf16
   weights under the HF ``CLIPModel`` names, a 49,408-id WordLevel
   tokenizer whose EOT id is 49407, a dataset of 1,000 labels and no
   ``.npy``, so the server embeds them at start-up through the causal text
   tower) served by ``serve()`` with ``batch_size: 64`` and warm-up on.
   Over gRPC: (a) 128 distinct 1600x1200 JPEGs through ``clip_image_embed``,
   64 in flight, decoded by the decode pool in its default mode; (b) 32
   ``clip_text_embed``; (c) 8 ``clip_classify`` (top 5) and 4
   ``clip_scene_classify``; (d) photo 0 again (a result-cache answer, no
   launch) and as a ``tensor/raw`` payload of its pixels, alone; (e) a
   malformed image (``INVALID_ARGUMENT``); (f) a hub of ``clip`` + ``vlm``
   (phase 6's directory): 4 caption streams while 32 photos embed. Every
   embedding is finite and unit-norm and within ``CLIP_COSINE`` of a direct
   ``CLIPModel`` on the card run with the plain attention (same weights,
   same pixels); the hub's captions equal phase 6's; the flash kernel runs
   in every block of both towers; after the hub stops, its batcher and
   engine threads and the decode pool's workers are gone.

9. face and graph CLIP as users reach them (no hand-written kernel lies on
   the face path or the ONNX bridge; the checks run the convolutions in
   IEEE float32, and (a) times a detector batch with TF32 too): (a) the
   ``buffalo_l`` pack's stand-ins (``lumen_tpu_torch/testing/
   face_standins.py``: the det_10g contract at 640x640, IResNet-50 at
   112x112, seeded weights and BN statistics, score heads calibrated to a
   sparse set) exported to ONNX on the CPU and served by ``serve()`` at
   ``batch_size: 16``: 32 photos through ``face_detect`` at 16 in flight,
   ``face_detect_and_embed``, ``face_embed`` with and without landmarks,
   and ``tensor/raw`` photos, every detection matched one to one (IoU >=
   ``FACE_IOU``) and every embedding within ``FACE_COSINE`` of the
   stand-ins run directly on the card (same pixels, a numpy decode of the
   raw outputs), bridge params and outputs on the card; load time,
   photos/s, client p50/p95, batch fill, one detector and one embedder
   batch timed with CUDA events, NMS launches and host ms, device-to-host
   syncs per forward, peak memory; (b) native ``DetectorConfig()`` /
   ``IResNetConfig()`` checkpoints held against the port's own CPU run of
   the same manager; (c) phase 8's ViT-B/32 exported to ONNX and served
   from an export-only directory with ``quantize: int8`` (ignored, with
   the warning) against phase 8's answers (``CLIP_COSINE``); (d) a hub of
   clip (native) + face: faces as (a)'s, embeddings as phase 8's, the
   flash kernel launched; after stop the batcher threads and decode
   workers are gone.

10. OCR as users reach it, and the full tier: (a) the ``PP-OCRv5_mobile``
   pack's stand-ins (``lumen_tpu_torch/testing/ocr_standins.py``: det,
   rec and cls graphs at the published contracts, seeded, BN statistics
   fit to synthetic pages and heads calibrated) exported to ONNX on the
   CPU and served by ``serve()`` from the YAML block ``config_gen`` writes
   for ``ocr`` (``batch_size: 8``, ``batch_buckets: [320, 640, 960]``): 32
   distinct 1280x960 JPEG pages of text lines at 8 in flight, 8 of them
   with ``use_angle_cls`` (a share of each page's lines turned 180
   degrees), timed with TF32 convolutions and held to ``OcrReference``
   (the stand-ins run directly in IEEE float32, the host steps written
   from the reference's algorithm) up to ``OCR_TF32_*``, then held
   strictly in IEEE float32 (every box at IoU >= ``OCR_IOU``, texts
   equal), with ``tensor/raw`` pages and the classifier off; each page is
   asked at thresholds in gaps of its reference's values; load time,
   pages/s, client p50/p95, one detector call and one recognizer chunk
   (CUDA events), host postprocess ms, syncs per forward, peak memory;
   (b) native ``DBNetConfig()`` + ``SVTRConfig()`` + ``ClsConfig()``,
   seeded and calibrated, written as native safetensors: bf16 on the
   head_dim-16 flash kernel (4 launches a recognizer chunk, exactly)
   against the port's plain path (logits within ``OCR_BF16_LOGIT_SHARE``,
   texts equal wherever the margins allow), float32 against the port's
   own CPU run; (c) the full tier: ocr, clip, face and vlm from one YAML
   in ``generate_config``'s shape over phases 6, 8, 9 and 10 (a)'s
   directories, every service healthy, each family answering as in its
   own phase, the three bf16 path kernels launched, the threads and
   decode workers gone after stop.

11. bulk ingest and search as users reach them, on (c)'s tier plus
   ``search`` from one YAML: (a) 128 distinct seeded 1600x1200 JPEGs
   (text pages, photos with bright discs, plain photos) through ``python
   -m lumen_tpu_torch.pipeline.cli`` (called in process) with
   ``--families clip,face,ocr`` at ``--batch-size 64``, then 16 of them
   again with ``vlm`` at ``--caption-max-tokens 32``, both with IEEE float32
   convolutions: every row's CLIP embedding within ``INGEST_COSINE`` of
   the served ``clip_image_embed`` of the same pixels, faces and OCR items
   matched to the served answers of the same pixels (phase 9's
   ``FACE_IOU``/``FACE_COSINE`` and score tolerance, phase 10's
   ``OCR_TF32_IOU`` with equal texts), every caption equal to the served
   ``vlm_generate``'s, the caption images decoded by the decode pool's
   ``vlm_canvas`` spec, the three bf16 path kernels launched; a warm
   re-run on the server's managers answers every photo from the result
   cache with no launch while ``index=`` upserts each embedding into the
   search service over gRPC; images/s, the stage stats, device ms of each
   stage on one 64-image batch (CUDA events), syncs, peak memory. (b)
   200,000 seeded unit vectors at dim 512 upserted through
   ``search_upsert`` in 1,024-row chunks over the default 3 shards, then
   512 ``search_query`` at k = 10 with 16 in flight held to the numpy
   oracle (recall@10 = 1.0 but for counted near-ties, scores within
   ``SEARCH_SCORE_TOL``, each photo at rank 1 of its own embedding), and
   queries during a flood of bulk upserts into one shard (appends and
   in-place updates) that see only committed states; upserted rows/s,
   query p50/p95, one scoring pass over a full shard (CUDA events).

12. every VLM and CLIP serving option of the JAX managers: (a) a
   FastVLM-style directory (phase 6's decoder; the FastViTHD stand-in of
   ``lumen_tpu_torch/testing/fastvlm_standins.py`` with its projector
   exported as ``onnx/vision_encoder.onnx`` at 1024 px, 256 tokens; no
   native vision weights) served by ``serve()`` from a YAML in
   ``generate_config``'s shape: 8 greedy ``vlm_generate`` and 2 streams of
   1600x1200 JPEGs at once, each equal to the manager's rerun alone, the
   graph tower on the card (IEEE float32) within ``GRAPH_TOWER_TOL`` of the
   stand-in module, no device-to-host sync in ``_prepare``, the tower's
   time (CUDA events), TTFT and load time; (b) ``quantize: int8`` with
   ``LUMEN_VLM_Q8_ROUTE=auto`` and warm-up on phase 6's directory: the
   A/B's two decode rates, its verdict and the peak memory across it, then
   a second boot that reads the verdict file and times nothing, routes and
   ``vlm-quant`` gauges matching the verdict; (c) ``scheduler: coalesce``
   on phase 6's directory in bf16 and int8: 8 greedy requests over the 64
   and 128 prompt buckets and 2 streams at once, each equal to its rerun
   alone through the coalescer, device-to-host syncs a decode step (at
   most 1; also counted with the per-layer ladder read the repair
   removed); (d) phase 8's ViT-B/32 with ``quantize: int8`` (W8A8) at
   batch 64: the A/B under ``LUMEN_CLIP_Q8_ROUTE=auto``, then a pinned
   int8 boot whose embeddings are within ``Q8_CLIP_COSINE`` of phase 8's
   bf16 ones. (a) must launch ``flash_attention_cache`` and
   ``paged_attention``, (c) ``flash_attention_cache`` (and ``w8a16_matmul``
   in int8), (d) ``flash_attention``; their launch counts are printed
   beside each kernel's row.

13. a disaggregated fleet on the one card: a prefill host
   (``LUMEN_FED_ROLE=prefill``) and a front tier (no service,
   ``LUMEN_FED_PEERS`` naming both backends) in processes of their own
   (the server CLI under ``--serve-host``, which reports what each launched),
   the decode host (``LUMEN_FED_ROLE=decode``) ``serve()``
   in this process, all on phase 6's directory at full width. (a) 8 greedy
   ``vlm_generate`` and 2 streams of phase 6's JPEGs through the front, 8 in
   flight (the streams first), 32 new tokens: every row's KV pages migrate
   after prefill
   (``migrated_out`` = ``migrated_in`` = 10, no fallback, no rejection), each
   answer equals the same request on one colocated host, the decode host
   launches ``flash_attention_cache`` 0 times and ``paged_attention`` more
   than 0, both hosts end with no live page; the bytes a row ships, the
   decode host's time from a commit's frame to its row admitted and from
   there to the first token, one commit frame's loopback rate, TTFT and
   tok/s migrated and colocated. (b) the decode host stops while 2 streams
   decode on it: both finish on the prefill host's ladder, equal to their
   control, no token repeated. (c) SIGTERM to the prefill host with
   ``LUMEN_DRAIN_ANNOUNCE_S``: the front records one drain handoff and no
   ``fed_peer_down`` for it. (d) two ``search`` backends behind a front hold
   50,000 seeded unit vectors at dim 512 in 8 shards (each backend the rows
   of the shards the front's ring gives it); 128 queries at k = 10 equal
   the exact oracle outside near-ties. The front tier must launch nothing and
   never initialize CUDA, and every host must exit 0 with its report.

14. the control plane as users reach it: (a) ``hardware_report()`` in a
   fresh process reports the card (``cuda``, the ``nvidia-smi`` name, one
   card) and recommends the H100 preset without a CUDA context in that
   process, and ``environment_report`` passes its torch, nvcc, driver and
   device checks; (b) the app (``lumen_tpu_torch.app``, aiohttp in process
   on a loopback port, real HTTP): ``hardware/detect``, ``config/generate``
   with that preset and ``tier: full`` into a temporary cache holding
   phases 12 (a), 9 (c), 9 (a) and 10 (a)'s stand-ins under the catalog
   names the YAML asks for (``FastVLM-0.5B``, ``MobileCLIP2-S2``,
   ``buffalo_l``, ``PP-OCRv5_mobile``), ``config/save``; ``python -m
   lumen_tpu_torch.core.cli`` ``validate``, ``list`` and ``download`` on it
   (nothing to fetch); ``install/setup`` with a venv and the model check;
   (c) ``server/start`` of the full tier under the app's ``ServerManager``
   (this script's ``--serve-host``) with ``LUMEN_COMPILE_CACHE_DIR``
   empty: healthy, then a greedy caption over gRPC, whose kernels build at
   first use, and ``/stats``' ``compile`` block counting the libraries the
   child built; (d) ``python -m lumen_tpu_torch.client``'s ``caps``,
   ``health``, ``topology``, ``embed-text``, ``embed-image``, ``faces``,
   ``ocr``, ``caption``, ``caption --stream`` and ``stats`` exit 0 with
   answers valid against their result schemas, the client's caption equal
   to that gRPC one (the result cache off), ``/api/v1/metrics`` counting
   the tasks; then ``server/restart`` from the warm directory and the same
   caption again with 0 builds, both times from start to ready and both
   first captions printed; (e) ``server/stop``: both children exit 0 and
   their readouts, read back from ``/api/v1/server/logs``, show
   ``paged_attention`` and ``flash_attention_cache`` launched.

15. a Qwen2-MoE VLM at Qwen1.5-MoE-A2.7B's widths (hidden 2048, 24
   layers, 16 heads of head_dim 128, 60 experts top-4 of width 1408, a
   shared expert of 5632, vocab 151,936; seeded bf16 weights made on the
   card, 14.3B parameters) behind the ViT tower: (a) ``VLMManager`` on the
   paged engine, phase 4's ten requests, then ``quantize="int8"`` with
   ``LUMEN_VLM_SPEC_K=4`` on phase 5's templated prompts (the int8
   projections are attention, the shared expert and the untied lm_head;
   router and expert banks stay bf16), greedy determinism on a repeat,
   peak memory; all five kernels launch, the cache and paged kernels at
   their head_dim-128 instances; then the decoder's cacheless forward on
   the kernels (the <128> flash instance) against the plain attention
   (``MOE_FORWARD_COSINE``); (b) a model directory of the same widths cut
   to 2 layers (HF Qwen2-MoE names, ~3.5 GiB) served by ``serve()`` over
   gRPC: 8 streams in flight and one ``vlm_generate``, request 0 equal to
   a direct ``VLMManager``; (c) one ``MoEFFN`` layer at full width on 8
   tokens against its plain per-expert loop, its time, the grouped
   product's (``torch._grouped_mm``, a library call: the JAX
   ``lax.ragged_dot`` is no Pallas kernel) and the byte bound of the
   experts chosen.

16. CLIP training on the port's SPMD layer (``lumen_tpu_torch.training``,
   ``lumen_tpu_torch.parallel``) in an NCCL process group of world size 1,
   axes ``{"data": 1, "model": 1}``: (a) ``ClipTrainer(CLIPConfig())``
   (ViT-B/32 and the 512-wide text tower, ~151M parameters, seeded) in
   fp32 with TF32 off, 30 steps on one seeded batch of 256 image-text
   pairs (``warmup_steps=2``): every loss finite, the last below the
   first, 0 flash launches (the towers train on the plain attention, as
   the JAX trainer runs XLA attention below 256 tokens); steps/s and
   pairs/s after warm-up, peak memory, syncs a step; (b) two steps at
   batch 16 from the same weights on the card and in the port on the CPU
   (``TRAIN_LOSS_RTOL``; parameters within two Adam steps), and one step
   with ``remat=True`` against the plain one's loss, with its peak; (c)
   ``TrainCheckpointer`` (``torch.distributed.checkpoint``): an async save
   at step 10 that returns while it writes, the restored state byte-equal
   to the saved one, a resumed run's steps 11-15 within
   ``TRAIN_RESUME_RTOL`` of the uninterrupted run's, retention; (d) ring
   and Ulysses attention at the VLM vision shape [1, 12, 256, 64], causal
   and not, against ``attention_reference`` (Ulysses launches the flash
   kernel, twice), ``pipeline_apply`` over one stage against the plain
   stage, and expert-parallel ``moe_ffn`` against the exact path, every
   collective on CUDA tensors (``SPMD_TOL``). No TPU kernel lies on the
   training path (the JAX trainer never reaches Pallas), so the kernel
   table gains no row.
17. serving over a ``model`` axis: phase 6's ``VLMConfig()`` directory and
    phase 8's CLIP ViT-B/32 directory served by ``serve()`` from configs
    carrying ``mesh: {model: 2}``, as two ranks sharing the one card over
    gloo (not NCCL, which refuses two ranks on one device): rank 0
    process and the worker rank ``serve()`` starts. Against TP = 1
    managers of the same weights on the same card, built first (the w8a16
    routing rule is sticky for the process): (a) fp32, 8 text prompts'
    greedy tokens at TP = 1 equal to the same 8 as gRPC streams at TP = 2
    (text and counts);
    (e) a row spilled from the TP pool resumes on the TP = 1 generator to
    the same fp32 tokens; (b) bf16, 8 photo requests: the first decode
    step's logits within ``TP_LOGIT_COSINE`` / ``TP_LOGIT_REL``, the greedy
    agreement as equal prefixes, and where a request parts from TP = 1 the
    TP = 1 top-2 logit gap at that token (it fails unless within twice the
    TP = 2 logit difference: a near tie), every rank launching
    ``PHASE17_KERNELS`` and synchronizing clean; (d) CLIP image and text embeddings within ``TP_CLIP_COSINE`` in
    bf16 and in W8A8 ``dynamic``; (c) int8 with speculation K=4, the
    varq kernel on both ranks and w8a16 on neither (the routing rule), the
    equal prefixes and both accept rates; (f) the worker rank killed: the
    next request fails and ``Health`` turns UNAVAILABLE within
    ``TP_DEATH_TIMEOUT_S`` + ``TP_DEATH_MARGIN_S``. Each part's seconds and
    each rank's peak memory are printed, and every kernel row gains phase
    17's launches a rank.
18. serving over an ``expert`` axis: a 2-layer directory at
    Qwen1.5-MoE-A2.7B's widths served at ``{expert: 2}`` (bf16, then int8
    with speculation) and ``{expert: 2, model: 2}`` by ranks sharing the
    card over gloo, against the mesh-less manager (``drive_ep``).
19. serving and ingest over a ``data`` axis in one process: phase 8's
    ViT-B/32 directory behind ``CLIPManager`` over ``{"data": 2}`` on the
    one card named twice (``devices=[cuda:0, cuda:0]``: no copy between
    cards, and the two places share one host's cores) and mesh-less on
    the same card, 128 JPEGs at batch 64: (a) embeddings within
    ``DATA_COSINE`` of the mesh-less run, top-1 labels equal but at near
    ties, ``flash_attention`` launched exactly twice as often a batch (a
    call a place a layer), images/s of both, the memory of one copy and
    of two; (b) the photo ingest (CLIP and phase 9's face pack, IEEE
    float32 convolutions) of 64 photos over the axis and mesh-less:
    records alike, one device-to-host sync a place a batch, images/s;
    (c) ``flash_attention`` at one place's shapes ``[32, 12, 50, 64]`` and
    causal ``[32, 8, 77, 64]`` against its plain version (phase 2's
    tolerance), timed beside its bound and SDPA in phase 2, before any
    serving phase; the kernel table gains the place's vision row with
    (a)'s launches.
20. serving and ingest over a ``data`` axis above a ``model`` axis
    (``drive_dp_tp``): ``{data: 2, model: 2}`` as two gloo ranks sharing
    the one card, each driving it named twice (the group's two data
    places), from ``serve()`` on the running group, against mesh-less
    managers on the card: (a) phase 8's ViT-B/32 in bf16, 128 pixels at
    batch 64, embeddings within ``TP_CLIP_COSINE``, top-1 labels equal but
    at near ties, ``flash_attention`` a vision layer a part on every place
    of both ranks; (b) the photo ingest of phase 19 (b)'s photos over that
    CLIP and phase 9's face pack on the same mesh, a sync a place a batch;
    (c) phase 6's ``VLMConfig()`` on ``{model: 2}`` with
    ``LUMEN_REPLICAS_VLM=2``: an engine a place, 2 requests of 12 greedy
    tokens on each, the cache and paged kernels at each engine's place on
    both ranks, tokens to phase 17 (b)'s rule; (d) NCCL at world size 1
    with its place named twice. Each rank and place prints its launches,
    peak memory and synchronize.
21. exported (ONNX) vision towers beside a ``model`` axis, as the
    ``cuda_h100_8_dp_tp`` preset serves FastVLM-0.5B and MobileCLIP2
    (``drive_graph_group``): one ``serve()`` of the preset's ``clip`` and
    ``vlm`` blocks with the mesh set to ``{data: 2, model: 2}``, on two
    gloo ranks sharing the card, each driving it named twice, with
    ``LUMEN_REPLICAS_VLM=2``; ``vlm`` phase 12 (a)'s FastVLM-style
    directory (phase 6's decoder, the FastViTHD stand-in at 1024 px and
    256 tokens as ``onnx/vision_encoder.onnx``), ``clip`` phase 9 (c)'s
    export-only ViT-B/32 towers; against mesh-less managers on the card
    from the same directories. (a) 2 greedy requests of 8 tokens on each
    engine with photos: tokens to phase 17 (b)'s rule, the cache and paged
    kernels at each engine's place on both ranks, the tower (and the
    graph CLIP) held by rank 0 alone, each rank's peak memory, the
    device-to-host syncs of one prepare step on rank 0; (b) 64 pixels
    through ``clip_image_embed``, a JPEG and 8 ``clip_text_embed`` over
    gRPC: embeddings within ``CLIP_COSINE``, no program of the group (rank
    1 runs no CLIP), one device-to-host copy a place a batch. It times
    nothing.
22. ``seq`` axes served as the JAX package serves them, one copy a data
    place (``drive_seq``): (a) phase 8's ViT-B/32 on ``{data: 2, seq: 2}``
    with the card named four times, against the mesh-less manager on the
    card: 64 pixels at batch 64, embeddings within ``CLIP_COSINE``,
    ``flash_attention`` a vision layer a part at each of the two serving
    places, the weights of two copies (the idle ``seq`` positions hold
    none); (b) phase 6's ``VLMConfig()`` directory by ``serve()`` on
    ``{model: 2, seq: 2}`` as two gloo ranks sharing the card, the
    group's one place a block of two ``seq`` positions: 2 photo requests
    of 8 greedy tokens to phase 17 (b)'s rule against the mesh-less
    manager, the cache and paged kernels on both ranks, one
    ``vlm_generate`` over gRPC. It times nothing but images/s and tok/s.
23. ``dtype: float16`` on the card, and the MoE decoder in float16 and
    float32 (``drive_fp16``): (a) one ``serve()`` of phase 6's
    ``VLMConfig()`` (speculation K=4), phase 8's ViT-B/32 and phase 10
    (b)'s native OCR, every block at ``dtype: float16``: captions equal
    to their reruns alone and a sampled one, the VLM's float16 forward
    to the plain attention (``FP16_FORWARD_COSINE``), CLIP embeddings to
    the towers on the plain attention (``CLIP_COSINE``), OCR boxes to the
    plain path's; (b) Qwen1.5-MoE-A2.7B's decoder cut to 2 layers at full
    width in float16 (speculation K=4, then a sampled request) and
    float32 on the paged engine, each one's forward to the plain
    attention, and one ``MoEFFN`` layer's syncs a call equal in bf16,
    float16 and float32. Every attention kernel must launch in float16
    and the grouped product in float16 and float32; each kernel's
    launches are printed by type and head_dim.

The counts above are each drive's defaults; ``main`` runs phases 7, 9-17
and 20 cut in depth to keep all twenty-three within the time limit (the
comments beside each call in ``main`` list the cuts).

Phases 12, 14, 21 then 23, and 16 then 22, run beside the main lane, each
lane a process of its own (``chip_smoke.py --beside``; ``BESIDE_LANES``):
12, 14, 21 and 23 once phase 8 has ended (14 waits for 9 and 10 too, 21
for 9, 23 for 10; 21 serves 12's directory), 16 and 22 once 15 has ended,
so 16's ~31 GiB never meets phase 15's ~39 GiB. A lane's launch counts are its own process's, as its
servers' and ranks' are theirs, so no phase reads another's launches.
Every lane ends before phase 19, which times kernels with the card to
itself. A lane's lines are echoed as they come.

A run with no arguments drives all twenty-three phases (``--phases 13``, a
developer's shortcut, drives the listed ones and those they read, and
prints neither of the last two lines), and prints each phase's seconds.
The kernel table's launch counts are
phase 6's (the bf16 server for the bf16 path's kernels, the int8 server
for the other two), its head_dim-16 row's phase 10 (b)'s, and its
head_dim-128 and Qwen1.5-MoE w8a16 rows phase 15 (a)'s, its float16
and grouped-product rows phase 23's; phases 7-11
print their own, phase 8 beside the flash kernel's two CLIP rows and
phase 10 beside its two OCR rows (timed in phase 2), phases 13 and 14
beside every kernel's row (decode and prefill hosts; the supervised full
tier). The last two lines are the
kernel table (JSON) and the device line the harness reads; the card's
name and power limit precede them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): memory rate and bf16 / fp16 /
#: fp32 (TF32) tensor-core rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}

#: kernel vs plain: |kernel - plain| <= ATOL + RTOL * |plain| elementwise,
#: with the plain version run in fp32 on the same (bf16) inputs. The
#: kernel accumulates in fp32 and rounds its output to bf16 once
#: (half an ulp: 2^-9 relative); the rest is summation order.
ATOL, RTOL = 1e-2, 1e-2

SOURCES = {
    "flash_attention": ("lumen_tpu_torch/csrc/flash_attention.cu", "lumen_tpu/ops/attention.py:173"),
    "flash_attention_cache": ("lumen_tpu_torch/csrc/flash_attention_cache.cu", "lumen_tpu/ops/attention.py:315"),
    "paged_attention": ("lumen_tpu_torch/csrc/paged_attention.cu", "lumen_tpu/ops/attention.py:676"),
    "paged_attention_varq": ("lumen_tpu_torch/csrc/paged_attention_varq.cu", "lumen_tpu/ops/attention.py:849"),
    "w8a16_matmul": ("lumen_tpu_torch/csrc/w8a16_matmul.cu", "lumen_tpu/ops/quant_matmul.py:76"),
    # no TPU kernel: the JAX grouped product is lax.ragged_dot, an XLA op
    "grouped_mm": ("lumen_tpu_torch/csrc/grouped_mm.cu", "lumen_tpu/parallel/moe.py:105"),
}

#: the kernels each serving phase must launch: phase 4 the bf16 path
#: (single-token paged decode), phase 5 the int8 speculative path.
PHASE4_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
PHASE5_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention_varq", "w8a16_matmul")
#: phase 6 holds its bf16 server to PHASE4_KERNELS and its int8 + speculation
#: server to these
PHASE6_INT8_KERNELS = ("paged_attention_varq", "w8a16_matmul")

#: (K, N) of the decoder's projections (Qwen2-0.5B), the w8a16 shapes.
Q8_SHAPES = {
    "q_proj/o_proj": (896, 896),
    "k_proj/v_proj": (896, 128),
    "gate_proj/up_proj": (896, 4864),
    "down_proj": (4864, 896),
}
#: (K, N) of the Qwen2-MoE decoder's int8 projections (Qwen1.5-MoE-A2.7B
#: widths): attention, the shared expert and the untied lm_head.
MOE_Q8_SHAPES = {
    "q/k/v/o_proj": (2048, 2048),
    "shared gate/up_proj": (2048, 5632),
    "shared down_proj": (5632, 2048),
    "lm_head": (2048, 151936),
}


def all_kernels() -> tuple:
    from lumen_tpu_torch.ops import attention, quant_matmul

    return attention.KERNELS + quant_matmul.KERNELS


def moe_kernels() -> tuple:
    """The MoE grouped product's kernel (float16 and float32 on the card;
    bf16 runs ``torch._grouped_mm``), built and counted apart from
    :func:`all_kernels`, whose launch tables every serving phase reads."""
    from lumen_tpu_torch.parallel import moe

    return moe.KERNELS


@contextlib.contextmanager
def env(**values: str):
    """Set environment knobs for the engines built inside; restore after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log(msg: str) -> None:
    # one write a line: the lanes' lines are echoed from other threads
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the idle time at each edge of a ``device_ms`` session
PROFILE_MARGIN_S = 0.02


def device_ms(
    fn, iters: int, args: list | None = None, *, floor_ms: float, launches: int | None = None,
    strict: bool = True, warmup: int = 3,
) -> float | None:
    """Device time of one call: the summed duration of the kernels (and
    copies) ``iters`` calls put on the card, from ``torch.profiler``, over
    ``iters``. Unlike ``cuda_ms`` it leaves out the host's launch path,
    which is longer than a small kernel. ``args``: argument tuples cycled
    call by call -- copies of the weights larger than the 50 MB L2 in all,
    so every launch reads its weights from device memory, as a decode
    step's layers do.

    The profiler can lose events: on the H100 machine (torch 2.11) a
    session came back with none at all, and others with a few kernels of a
    hundred calls missing. So the time of a call is each kernel's mean
    duration over the events the session kept, times the launches of that
    kernel a call (its count over ``iters``, rounded); a lost event then
    biases nothing. A session counts only if it kept, of each kernel, at
    least 90% of the events the calls launched (and no more), exactly
    ``launches`` kernels per call when given, and the time per call is not
    below ``floor_ms``, the call's bound. Otherwise it is profiled again, up to five times; then the run
    fails, or, with ``strict=False``, the reading is None: not valid, and
    never printed as a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = args or [()]
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    for attempt in range(5):
        # The profiler keeps a kernel's record only if its time, taken on
        # the card's clock, falls inside the session on the host's; calls
        # that start or end at the session's edges lost their records (a
        # session kept 1 of 50 calls of a 6 us kernel), so the calls run
        # between idle margins.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for i in range(iters):
                fn(*args[i % len(args)])
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        per_call = {e.key: max(1, round(e.count / iters)) for e in events}
        kept = sum(e.count for e in events)
        short = [e.count for e in events if not 0.9 * per_call[e.key] * iters <= e.count <= per_call[e.key] * iters]
        ms = sum(e.self_device_time_total / e.count * per_call[e.key] for e in events) / 1e3
        if not events:
            fault = "no device events"
        elif short:
            fault = f"kernel counts {sorted(short)} not within 90-100% of a multiple of {iters} calls"
        elif launches is not None and sum(per_call.values()) != launches:
            fault = f"{sum(per_call.values())} kernels a call, not {launches}"
        elif ms < floor_ms:
            fault = f"{ms:.5f} ms a call, below the {floor_ms:.5f} ms bound"
        else:
            if kept != iters * sum(per_call.values()):
                log(f"torch.profiler kept {kept} of {iters * sum(per_call.values())} kernel events; the time is "
                    f"each kernel's mean over the events kept")
            return ms
        log(f"torch.profiler session {attempt + 1} of 5 not valid: {fault}")
    if strict:
        raise AssertionError(f"torch.profiler gave no valid session in five: {fault}")
    return None


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    """Max |out - ref|; fails when any element is outside the tolerance
    or not finite."""
    import torch

    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((diff > ATOL + RTOL * ref.abs()).any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| {diff.max().item():.3e}")
    return float(diff.max())


# -- phase 2: kernels vs plain ------------------------------------------------


def paged_sets(gen, lens: list, q_shape: tuple, maxp: int, kv_heads: int, dtype, page: int = 16,
               min_bytes: float = 120e6) -> tuple:
    """Disjoint copies of one paged call, to time it from device memory as
    a decode step's layers find their pools (each layer its own, the MLP
    weights streamed in between): a pool of ``n`` times the pages the
    rows' live keys (and a window's W - 1 more positions) occupy, and
    ``n`` (q, block table) pairs over disjoint pages, the dump page 0
    past each row's pages; ``n`` makes the live K/V of the copies pass
    ``min_bytes``, beyond the 50 MB L2. ``q_shape`` is [B, H, D] (decode)
    or [B, W, H, D] (verify). Returns (k_pages, v_pages, [(q, table),
    ...])."""
    import torch

    dev = torch.device("cuda:0")
    window, d = (q_shape[1] if len(q_shape) == 4 else 1), q_shape[-1]
    per_row = [-(-(n + window - 1) // page) for n in lens]
    need = sum(per_row)
    live = 2 * need * page * kv_heads * d * torch.finfo(dtype).bits // 8
    n = max(2, math.ceil(min_bytes / live))
    pool = n * need + 1
    kp = torch.randn((pool, kv_heads, page, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((pool, kv_heads, page, d), generator=gen, device=dev).to(dtype)
    perm = (torch.randperm(pool - 1, generator=gen, device=dev) + 1).to(torch.int32)
    sets, i = [], 0
    for _ in range(n):
        bt = torch.zeros((len(lens), maxp), dtype=torch.int32, device=dev)
        for r, k in enumerate(per_row):
            bt[r, :k] = perm[i:i + k]
            i += k
        sets.append((torch.randn(q_shape, generator=gen, device=dev).to(dtype), bt))
    return kp, vp, sets


def paged_plan_on_card(group: int, head_dim: int, window: int, dtype) -> dict:
    """The plan both paged libraries launch for a call of this shape
    (``lumen_paged_plan``), which must equal its Python twin
    ``ops.attention.paged_plan``; ``resident`` is the occupancy
    calculator's blocks an SM on this card."""
    from lumen_tpu_torch.ops import attention as A

    code = A._DTYPE_CODES[dtype]
    got = {f: A.PAGED.query("lumen_paged_plan", group, head_dim, window, code, i)
           for i, f in enumerate(A.PAGED_PLAN_FIELDS)}
    got_varq = {f: A.PAGED_VARQ.query("lumen_paged_plan", group, head_dim, window, code, i)
                for i, f in enumerate(A.PAGED_PLAN_FIELDS)}
    want = A.paged_plan(group, head_dim, window, dtype)
    if {f: got[f] for f in want} != want or got != got_varq or got["resident"] < 1:
        raise AssertionError(f"paged plan of (group {group}, head_dim {head_dim}, W {window}, {dtype}): "
                             f"library {got}, varq library {got_varq}, ops.attention.paged_plan {want}")
    return got


def paged_plan_text(q, k_pages, maxp: int) -> str:
    """The plan of a paged call on ``q`` ([B, (W,) H, D]) against pages
    [P, KVH, page, D] with ``maxp``-page tables, as the library reports it,
    with its grid and workspace."""
    from lumen_tpu_torch.ops import attention as A

    b, w, h, d = q.shape[0], (q.shape[1] if q.dim() == 4 else 1), q.shape[-2], q.shape[-1]
    kvh, page = k_pages.shape[1], k_pages.shape[2]
    plan = paged_plan_on_card(h // kvh, d, w, q.dtype)
    size = A.paged_launch(plan, b, w, h, kvh, maxp, page, d)
    return (f"{'tensor cores' if plan['mma'] else 'FMA units'}, {plan['rows']} query rows a block ({plan['kv_heads']} "
            f"KV head(s) x {plan['slots']} slot(s) x group {h // kvh}), {plan['slot_groups']} slot group(s), span "
            f"{plan['span']}, {size['grid'][0]}x{size['grid'][1]} blocks, {plan['threads']} threads, {plan['smem']} B "
            f"dynamic smem, {plan['resident']} resident an SM, workspace {size['workspace']} B")


def check_paged_bits(q, k_pages, v_pages, bt, kl, label: str) -> None:
    """The bitwise properties the greedy identity of speculation leans on:
    for a verify call (``q`` [B, W, H, D]) slot t equals the single-token
    kernel at ``kv_lens + t``; for either kernel each row launched alone
    equals the same row in the batch."""
    import torch

    from lumen_tpu_torch.ops import attention as A

    fn = A.paged_attention_varq_kernel if q.dim() == 4 else A.paged_attention_kernel
    out = fn(q, k_pages, v_pages, bt, kl)
    if q.dim() == 4:
        for t in range(q.shape[1]):
            one = A.paged_attention_kernel(q[:, t].contiguous(), k_pages, v_pages, bt, kl + t)
            if not torch.equal(out[:, t], one):
                raise AssertionError(f"{label}: verify slot {t} differs from paged_attention at kv_lens + {t}")
    for i in range(q.shape[0]):
        alone = fn(q[i:i + 1].clone(), k_pages, v_pages, bt[i:i + 1].clone(), kl[i:i + 1].clone())
        if not torch.equal(alone, out[i:i + 1]):
            raise AssertionError(f"{label}: row {i} alone differs from the same row in the batch of {q.shape[0]}")


def cache_tile_shape(head_dim: int = 64) -> dict:
    """Block shape of flash_attention_cache's bf16 tile, from the constants
    of ``csrc/flash_tile_bf16.cuh``: query rows (16 per row group),
    threads (a warp per row group and key part) and dynamic shared memory
    (the K/V ring and the Q/O rows, rows of head_dim + 8 bf16)."""
    text = (ROOT / "lumen_tpu_torch" / "csrc" / "flash_tile_bf16.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
         for n in ("kFlashWarps", "kFlashSplit", "kFlashStages")}
    rows = 16 * c["kFlashWarps"]
    return dict(rows=rows, threads=32 * c["kFlashWarps"] * c["kFlashSplit"],
                smem=(2 * c["kFlashStages"] * 64 + rows) * (head_dim + 8) * 2)


def flash_plan_on_card(sq: int, sk: int, head_dim: int, causal: bool) -> dict:
    """The plan the flash library launches for a bf16 call of this shape
    (``lumen_flash_plan``), which must equal its Python twin
    ``ops.attention.flash_plan``; ``resident`` is the occupancy
    calculator's blocks an SM on this card."""
    from lumen_tpu_torch.ops import attention as A

    got = {f: A.FLASH.query("lumen_flash_plan", sq, sk, head_dim, int(causal), i)
           for i, f in enumerate(A.FLASH_PLAN_FIELDS)}
    got["path"] = ("short", "long")[got["path"]]
    want = A.flash_plan(sq, sk, head_dim, causal)
    if {f: got[f] for f in want} != want or got["resident"] < 1:
        raise AssertionError(f"flash plan of [{sq}, {sk}, {head_dim}, causal={causal}]: library {got}, "
                             f"ops.attention.flash_plan {want}")
    return got


def plan_text(plan: dict) -> str:
    return (f"{plan['path']} path, {plan['rows']} query rows x {plan['split']} key part(s) a block, "
            f"{plan['keys']}-key softmax steps, {plan['stages']} ring slots, {plan['threads']} threads, "
            f"{plan['smem']} B dynamic smem, "
            f"{plan['row_blocks']} row block(s) a (b, h)" + (", heaviest first" if plan["heaviest_first"] else "")
            + f"; {plan['resident']} blocks resident an SM")


def flash_row(rnd, label: str, b: int, h: int, s: int, d: int, causal: bool, plain_iters: int = 20,
              dtype=None) -> dict:
    """One flash_attention shape of the kernel table, [b, h, s, d] bf16
    (or ``dtype``, a 2-byte type: the same plan):
    the kernel against the plain version (tolerance), then in one run the
    kernel's device time, the plain version's, SDPA's on the same tensors
    and the bound -- the largest of q, k, v, o once at 3.35 TB/s, the
    FLOPs at 989 TFLOP/s and the exp2 of every visible (query, key) pair
    on the SFU at ``EXP_PER_S`` -- with the plan the
    library launches and its blocks resident an SM."""
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    q, k, v = (rnd(b, h, s, d) if dtype is None else rnd(b, h, s, d, dtype=dtype) for _ in range(3))
    err = max_err(A.flash_attention(q, k, v, causal=causal),
                  A.attention_reference(q.float(), k.float(), v.float(), causal=causal))
    plan = flash_plan_on_card(s, s, d, causal)
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    terms = dict(bytes_ms=4 * q.numel() * 2 / HBM_BYTES_PER_S * 1e3,
                 flops_ms=4 * pairs * d / PEAK_FLOPS["bfloat16"] * 1e3,
                 exp_ms=pairs / EXP_PER_S * 1e3)
    bms, by = bound(4 * q.numel() * 2, 4 * pairs * d, "bfloat16")
    if terms["exp_ms"] > bms:
        bms, by = terms["exp_ms"], "operations"
    row = dict(
        max_abs_err=err,
        ms=device_ms(lambda: A.flash_attention(q, k, v, causal=causal), 50, floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.attention_reference(q, k, v, causal=causal), plain_iters, floor_ms=bms),
        bound_ms=bms, bound_by=by, bound_terms=terms,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 50, floor_ms=bms),
        shape=f"[{b},{h},{s},{d}]" + (" causal" if causal else ""), plan=plan,
    )
    log(f"kernel flash_attention {label} {row['shape']}: plan {plan_text(plan)}; kernel {row['ms']:.4f} ms on the "
        f"device, SDPA {row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}x), bound {bms:.5f} ms ({by}: "
        f"terms {json.dumps({t: round(x, 5) for t, x in terms.items()})}), plain {row['plain_ms']:.4f} ms, max|diff| "
        f"{err:.3e}")
    return row


def check_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16
    tile = cache_tile_shape()

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def f32(*ts):
        return [t.float() for t in ts]

    rows = {}

    # flash_attention: a non-causal length off the 64-key tile, causal
    # cases with lengths off the tiles (sk > sq: the long path with a
    # diagonal offset), and the fp32 instance (FMA tile) on one; then the
    # kernel table's shapes: the vision tower's [1, 12, 256, 64]
    # bidirectional call (the long path), and the CLIP towers' calls
    # (phase 8) at the bulk batch, the ViT-B/32 vision tower's 50 tokens,
    # bidirectional, and the text tower's 77, causal (the short path).
    errs = []
    for b, h, sq, sk, causal, dt in (
        (1, 12, 100, 100, False, bf16), (2, 14, 77, 77, True, bf16), (1, 14, 50, 130, True, bf16),
        (1, 14, 50, 130, True, torch.float32), (3, 2, 200, 64, False, bf16), (2, 2, 129, 129, True, bf16),
    ):
        q, k, v = rnd(b, h, sq, 64, dtype=dt), rnd(b, h, sk, 64, dtype=dt), rnd(b, h, sk, 64, dtype=dt)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.attention_reference(*f32(q, k, v), causal=causal)
        errs.append(max_err(out, ref))
    row = flash_row(rnd, "VLM vision", 1, 12, 256, 64, False)
    rows["flash_attention"] = dict(row, max_abs_err=max(errs + [row["max_abs_err"]]))
    for label, (b, h, s, causal) in CLIP_FLASH_SHAPES.items():
        rows[f"flash_attention ({label})"] = flash_row(rnd, label, b, h, s, 64, causal)
    # a place's part of the bulk batch over {"data": 2} (phase 19), timed
    # here: after phase 19's serving, sessions kept as few as 38 of 50 of
    # a call's records, in all five tries
    for label, (b, h, s, causal) in DATA_FLASH_SHAPES.items():
        rows[f"flash_attention ({label})"] = flash_row(rnd, label, b, h, s, 64, causal)
    # A row's bits do not depend on how many sequences share the call (the
    # plan is a function of the shape alone): image 0 alone vs in the 64.
    q, k, v = (rnd(64, 12, 50, 64) for _ in range(3))
    if not torch.equal(A.flash_attention(q[:1], k[:1], v[:1]), A.flash_attention(q, k, v)[:1]):
        raise AssertionError("flash_attention: a sequence's output changed with the batch it was launched in")

    # The native OCR recognizer's calls at head_dim 16 (phase 10 (b)): the
    # 320 and 640 width buckets' chunks in bf16 (the table's rows), the 80
    # bucket's 240 tokens in fp32 (the FMA tile: a float32 recognizer),
    # and causal cases (SVTR is bidirectional; the kernel takes both).
    errs = []
    for b, h, s, causal, dt in ((2, 4, 240, False, torch.float32), (2, 4, 240, True, bf16),
                                (1, 4, 100, True, torch.float32), (3, 4, 77, False, bf16)):
        q, k, v = rnd(b, h, s, 16, dtype=dt), rnd(b, h, s, 16, dtype=dt), rnd(b, h, s, 16, dtype=dt)
        errs.append(max_err(A.flash_attention(q, k, v, causal=causal),
                            A.attention_reference(*f32(q, k, v), causal=causal)))
    for d in (32, 80):
        try:
            A.flash_attention(*(rnd(1, 2, 8, d) for _ in range(3)))
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took head_dim {d} on the card; its kernel is built for 16, 64 and 128")
    for label, (b, h, s) in OCR_FLASH_SHAPES.items():
        row = flash_row(rnd, label, b, h, s, 16, False, plain_iters=10)
        rows[f"flash_attention ({label})"] = dict(row, max_abs_err=max(errs + [row["max_abs_err"]]))
    log("kernel flash_attention at head_dim 16: bf16 and fp32, causal and not, within tolerance; head_dims 32/80 "
        "raise")

    # flash_attention_cache against the 832-slot scratch: the chunk lane's
    # two chunks of a caption prompt (265 live tokens, bucket span 319), a
    # ragged two-row batch, kv_valid on either side of the 64-key tile, a
    # causal diagonal crossing a tile mid-warp, two rows with different
    # offsets, and the fp32 instance (FMA tile) on chunk 2. Then the
    # coalescer's whole-prompt prefills (phase 12 (c)): up to 8 rows of the
    # 128 bucket's 383-token span against its 896-slot buffer and of the 64
    # bucket's 319 against 832, offsets 0, live lengths uneven, in bf16 and
    # fp32; a stream's prefill into a max_seq (2048) buffer; the int8
    # route A/B's 16-token prefills (the fused decode's 88-slot buffer,
    # the engine probe's 16-slot scratch).
    errs = []
    cases = (
        (1, 256, 832, [0], [256], bf16),
        (1, 63, 832, [256], [265], bf16),
        (2, 256, 832, [0, 256], [256, 300], bf16),
        (1, 48, 832, [15], [63], bf16),
        (1, 48, 832, [16], [64], bf16),
        (1, 48, 832, [17], [65], bf16),
        (1, 48, 832, [79], [127], bf16),
        (1, 64, 832, [100], [164], bf16),
        (2, 63, 832, [256, 37], [265, 100], bf16),
        (1, 63, 832, [256], [265], torch.float32),
        (8, 383, 896, [0] * 8, [383, 265, 300, 320, 266, 383, 290, 271], bf16),
        (8, 383, 896, [0] * 8, [383, 265, 300, 320, 266, 383, 290, 271], torch.float32),
        (4, 319, 832, [0] * 4, [319, 265, 270, 300], bf16),
        (4, 319, 832, [0] * 4, [319, 265, 270, 300], torch.float32),
        (1, 319, 2048, [0], [265], bf16),
        (1, 383, 2048, [0], [330], bf16),
        (4, 16, 88, [0] * 4, [16] * 4, bf16),
        (4, 16, 16, [0] * 4, [16] * 4, bf16),
    )
    for b, sq, sk, offs, valid, dt in cases:
        q, k, v = rnd(b, 14, sq, 64, dtype=dt), rnd(b, 14, sk, 64, dtype=dt), rnd(b, 14, sk, 64, dtype=dt)
        qo = torch.tensor(offs, device=dev, dtype=torch.int32)
        kv = torch.tensor(valid, device=dev, dtype=torch.int32)
        out = A.flash_attention_cache(q, k, v, qo, kv)
        ref = A._decode_masked(*f32(q, k, v), qo, kv)
        errs.append(max_err(out, ref))

    def chunk(q, k, v, off: int, live: int) -> dict:
        """A prompt chunk ``q`` at offset ``off`` against the scratch
        ``k``/``v`` with ``live`` slots: kernel, plain, bound, and SDPA
        with the bool mask of the same function."""
        sq = q.shape[2]
        qo = torch.tensor([off], device=dev, dtype=torch.int32)
        kv = torch.tensor([live], device=dev, dtype=torch.int32)
        pairs = sum(min(live, off + i + 1) for i in range(sq))  # visible (query, key) pairs
        nb = 2 * q.numel() * 2 + 2 * 14 * live * 64 * 2  # q, out, live K/V slots
        bms, by = bound(nb, 4 * 14 * 64 * pairs, "bfloat16")
        slots = torch.arange(832, device=dev)
        rows_abs = off + torch.arange(sq, device=dev)
        mask = ((slots[None, :] < live) & (slots[None, :] <= rows_abs[:, None]))[None, None]
        return dict(
            ms=device_ms(lambda: A.flash_attention_cache(q, k, v, qo, kv), 50, floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A._decode_masked(q, k, v, qo, kv), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50, floor_ms=bms),
            blocks=-(-sq // tile["rows"]) * 14,
        )

    k, v = rnd(1, 14, 832, 64), rnd(1, 14, 832, 64)
    c2 = chunk(rnd(1, 14, 63, 64), k, v, 256, 265)
    log(f"kernel flash_attention_cache chunk 2 (q [1,14,63,64], q_off 256, kv_valid 265): "
        f"kernel {c2['ms']:.4f} ms on the device ({c2['blocks']} blocks), plain {c2['plain_ms']:.4f} ms, "
        f"bound {c2['bound_ms']:.5f} ms ({c2['bound_by']}), library (SDPA, bool mask) {c2['library_ms']:.4f} ms")
    q = rnd(1, 14, 256, 64)
    c1 = chunk(q, k, v, 0, 256)
    # A stricter yardstick, printed only: SDPA is_causal on the 256 live
    # keys alone (it never sees the dead slots; the masked call above is
    # the one that computes the kernel's function).
    k256, v256 = k[:, :, :256].contiguous(), v[:, :, :256].contiguous()
    causal_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k256, v256, is_causal=True), 50,
                          floor_ms=c1["bound_ms"])
    log(f"kernel flash_attention_cache chunk 1: yardstick SDPA is_causal on the 256 live keys "
        f"{causal_ms:.4f} ms (printed only; the table's library call is SDPA with the bool mask)")
    rows["flash_attention_cache"] = dict(c1, max_abs_err=max(errs))

    # paged_attention: 8 decode rows over a 1025-page pool, ragged
    # lengths (one token, exactly one page, partial last pages, a long
    # row), tables padded with the dump page and stale page ids.
    pages = 1025
    span = A.paged_plan(7, 64, 1, bf16)["span"]
    kp, vp = rnd(pages, 2, 16, 64), rnd(pages, 2, 16, 64)
    lens = [1, 16, 17, 300, 333, 129, 64, 500]

    def table(row_lens: list[int], maxp: int):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: len(row_lens) * maxp]
        bt = (perm.reshape(len(row_lens), maxp) + 1).to(torch.int32)
        for r, n in enumerate(row_lens):
            if r % 2:
                bt[r, -(-n // 16):] = 0  # dump page
        return bt

    bt = table(lens, 32)
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    q = rnd(8, 14, 64)
    out = A.paged_attention_kernel(q, kp, vp, bt, kl)
    errs = [max_err(out, A.paged_attention_reference(*f32(q, kp, vp), bt, kl))]
    # The span's edges and a 2048-token row (maxp 128), in both dtypes.
    edge = [span - 1, span, span + 1, 2048]
    bt_edge = table(edge, 128)
    kl_edge = torch.tensor(edge, device=dev, dtype=torch.int32)
    for dt in (bf16, torch.float32):
        qe = rnd(4, 14, 64, dtype=dt)
        kpe, vpe = kp.to(dt), vp.to(dt)
        out_e = A.paged_attention_kernel(qe, kpe, vpe, bt_edge, kl_edge)
        errs.append(max_err(out_e, A.paged_attention_reference(*f32(qe, kpe, vpe), bt_edge, kl_edge)))
    # Bitwise: a row's output does not depend on the table's width (a
    # decode step's page bucket vs a verify turn's).
    bt_wide = torch.zeros((8, 128), device=dev, dtype=torch.int32)
    bt_wide[:, :32] = bt
    if not torch.equal(A.paged_attention_kernel(q, kp, vp, bt_wide, kl), out):
        raise AssertionError("paged_attention: a row's output changed with the table padded from 32 to 128 pages")
    check_paged_bits(q, kp, vp, bt, kl, "paged_attention")
    check_paged_bits(q.float(), kp.float(), vp.float(), bt, kl, "paged_attention fp32")
    torch.cuda.synchronize()
    working = 2 * sum(-(-n // span) for n in lens)
    log(f"kernel paged_attention: lengths {span - 1}/{span}/{span + 1}/2048 (maxp 128) in bf16 and fp32 within "
        f"tolerance; rows bitwise equal with tables of 32 and 128 pages and alone vs in the batch of 8 (bf16, "
        f"fp32); {working} working blocks at q [8,14,64], maxp 32; plan {paged_plan_text(q, kp, 32)}; fp32 plan "
        f"{paged_plan_text(q.float(), kp, 32)}")
    total = sum(lens)
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * total * 2 * 64 * 2
    bms, by = bound(nb, 4 * 14 * 64 * total, "bfloat16")
    hkp, hvp, sets = paged_sets(gen, lens, (8, 14, 64), 32, 2, bf16)
    rows["paged_attention"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.paged_attention_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
        hbm_ms=device_ms(lambda q, bt: A.paged_attention_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                         floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by, library_ms=None,
    )
    del hkp, hvp, sets
    for name, row in rows.items():
        blocks = (f" ({row['blocks']} blocks of {tile['rows']} query rows, {tile['threads']} threads, "
                  f"{tile['smem']} B dynamic shared memory)") if "blocks" in row else ""
        if "hbm_ms" in row:
            blocks += f" warm, {row['hbm_ms']:.4f} ms from device memory"
        log(
            f"kernel {name}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), "
            f"kernel {row['ms']:.4f} ms on the device{blocks}, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), library "
            + ("n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
        )
    return rows


def check_hd128(seed: int) -> dict:
    """The head_dim-128 instances (the Qwen2-MoE decoder's: 16 heads, 16
    KV heads) against their plain versions at phase 15's shapes, with
    ragged cases and the fp32 instances: flash causal [1,16,265,128] (the
    decoder's cacheless forward of a caption prompt), the cache kernel's
    chunk q [1,16,256,128] against the 832-slot scratch, paged decode q
    [8,16,128] at lengths 1..500 (and at the span's edges and a 2048-token
    row in both dtypes; rows bitwise equal with tables of 32 and 128
    pages), the verify window [8,5,16,128] (W = 1 bitwise the single-token
    kernel). Returns the four rows for the kernel table."""
    import torch
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 128)
    bf16, f32t, d, h = torch.bfloat16, torch.float32, 128, 16
    tile = cache_tile_shape(d)

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def f32(*ts):
        return [t.float() for t in ts]

    rows = {}
    errs = []
    for b, hh, sq, sk, causal, dt in ((1, h, 265, 265, True, bf16), (2, h, 77, 77, False, bf16),
                                      (1, h, 50, 130, True, bf16), (1, 4, 100, 100, True, f32t)):
        q, k, v = rnd(b, hh, sq, d, dtype=dt), rnd(b, hh, sk, d, dtype=dt), rnd(b, hh, sk, d, dtype=dt)
        errs.append(max_err(A.flash_attention(q, k, v, causal=causal), A.attention_reference(*f32(q, k, v), causal=causal)))
    for bad in (32, 80):
        try:
            A.flash_attention(*(rnd(1, 2, 8, bad) for _ in range(3)))
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took head_dim {bad} on the card; its kernel is built for 16, 64 and 128")
    row = flash_row(rnd, "head_dim 128 (Qwen2-MoE cacheless forward)", 1, h, 265, d, True)
    rows["flash_attention [head_dim 128]"] = dict(row, max_abs_err=max(errs + [row["max_abs_err"]]))

    errs = []
    for b, sq, sk, offs, valid, dt in ((1, 256, 832, [0], [256], bf16), (1, 9, 832, [256], [265], bf16),
                                       (2, 63, 832, [256, 37], [265, 100], bf16), (1, 48, 832, [79], [127], bf16),
                                       (1, 63, 832, [256], [265], f32t)):
        q, k, v = rnd(b, h, sq, d, dtype=dt), rnd(b, h, sk, d, dtype=dt), rnd(b, h, sk, d, dtype=dt)
        qo = torch.tensor(offs, device=dev, dtype=torch.int32)
        kv = torch.tensor(valid, device=dev, dtype=torch.int32)
        errs.append(max_err(A.flash_attention_cache(q, k, v, qo, kv), A._decode_masked(*f32(q, k, v), qo, kv)))
    q, k, v = rnd(1, h, 256, d), rnd(1, h, 832, d), rnd(1, h, 832, d)
    qo = torch.tensor([0], device=dev, dtype=torch.int32)
    kv = torch.tensor([256], device=dev, dtype=torch.int32)
    pairs = 256 * 257 // 2
    bms, by = bound(2 * q.numel() * 2 + 2 * h * 256 * d * 2, 4 * h * d * pairs, "bfloat16")
    slots = torch.arange(832, device=dev)
    mask = ((slots[None, :] < 256) & (slots[None, :] <= torch.arange(256, device=dev)[:, None]))[None, None]
    rows["flash_attention_cache [head_dim 128]"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.flash_attention_cache(q, k, v, qo, kv), 50, floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A._decode_masked(q, k, v, qo, kv), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50, floor_ms=bms),
        blocks=-(-256 // tile["rows"]) * h, smem=tile["smem"], shape="q [1,16,256,128] vs 832 slots, 256 live",
    )

    pages, page = 1025, 16
    span = A.paged_plan(1, d, 1, bf16)["span"]
    kp, vp = rnd(pages, h, page, d), rnd(pages, h, page, d)

    def table(row_lens, maxp):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: len(row_lens) * maxp]
        bt = (perm.reshape(len(row_lens), maxp) + 1).to(torch.int32)
        for r, n in enumerate(row_lens):
            if r % 2:
                bt[r, -(-n // page):] = 0  # dump page
        return bt

    lens = [1, 16, 17, 300, 333, 129, 64, 500]
    bt = table(lens, 32)
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    q = rnd(8, h, d)
    out = A.paged_attention_kernel(q, kp, vp, bt, kl)
    errs = [max_err(out, A.paged_attention_reference(*f32(q, kp, vp), bt, kl))]
    edge = [span - 1, span, span + 1, 2048]
    bt_edge = table(edge, 128)
    kl_edge = torch.tensor(edge, device=dev, dtype=torch.int32)
    for dt in (bf16, f32t):  # fp32 at head_dim 128 opts into 66 KB of shared memory
        qe = rnd(4, h, d, dtype=dt)
        kpe, vpe = kp.to(dt), vp.to(dt)
        errs.append(max_err(A.paged_attention_kernel(qe, kpe, vpe, bt_edge, kl_edge),
                            A.paged_attention_reference(*f32(qe, kpe, vpe), bt_edge, kl_edge)))
        del kpe, vpe
    bt_wide = torch.zeros((8, 128), device=dev, dtype=torch.int32)
    bt_wide[:, :32] = bt
    if not torch.equal(A.paged_attention_kernel(q, kp, vp, bt_wide, kl), out):
        raise AssertionError("paged_attention <128>: a row's output changed with the table padded to 128 pages")
    check_paged_bits(q, kp, vp, bt, kl, "paged_attention <128>")
    kpf, vpf = kp.float(), vp.float()
    check_paged_bits(q.float(), kpf, vpf, bt, kl, "paged_attention <128> fp32")
    del kpf, vpf
    log(f"kernel paged_attention <128>: plan {paged_plan_text(q, kp, 32)}; fp32 plan {paged_plan_text(q.float(), kp, 32)}")
    total = sum(lens)
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * total * h * d * 2
    bms, by = bound(nb, 4 * h * d * total, "bfloat16")
    hkp, hvp, sets = paged_sets(gen, lens, (8, h, d), 32, h, bf16)
    rows["paged_attention [head_dim 128]"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.paged_attention_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
        hbm_ms=device_ms(lambda q, bt: A.paged_attention_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                         floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by, library_ms=None, shape="q [8,16,128], lens 1..500, maxp 32",
    )
    del hkp, hvp, sets

    errs = []
    maxp = 34
    lens = [1, 16, 15, 300, 333, 129, 62, 500]
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    cases = {}
    for w in (1, 5, 16):
        bt = (torch.randperm(pages - 1, generator=gen, device=dev)[: 8 * maxp].reshape(8, maxp) + 1).to(torch.int32)
        for r, n in enumerate(lens):
            if r % 2:
                bt[r, -(-(n + w - 1) // page):] = 0
        q = rnd(8, w, h, d)
        out = A.paged_attention_varq_kernel(q, kp, vp, bt, kl)
        errs.append(max_err(out, A.paged_attention_varq_reference(*f32(q, kp, vp), bt, kl)))
        check_paged_bits(q, kp, vp, bt, kl, f"paged_attention_varq <128> W={w}")
        cases[w] = (q, bt)
    # The fp32 instance, GQA group 2, at W = 3, 5 and 16 (bitwise to the
    # single-token kernel too).
    kpf, vpf = kp[:, :2].float().contiguous(), vp[:, :2].float().contiguous()
    btf, klf = bt[:2].contiguous(), kl[:2].contiguous()
    for w in (3, 5, 16):
        qf = rnd(2, w, 4, d, dtype=f32t)
        errs.append(max_err(A.paged_attention_varq_kernel(qf, kpf, vpf, btf, klf),
                            A.paged_attention_varq_reference(qf, kpf, vpf, btf, klf)))
        check_paged_bits(qf, kpf, vpf, btf, klf, f"paged_attention_varq <128> fp32 W={w}")
    del kpf, vpf
    w = 5
    q, bt = cases[w]
    log(f"kernel paged_attention_varq <128> W=5: plan {paged_plan_text(q, kp, maxp)}; W=16: plan "
        f"{paged_plan_text(cases[16][0], kp, maxp)}; fp32 (group 2) W=5: plan {paged_plan_text(qf[:, :5], kp[:, :2], maxp)}")
    live = sum(n + w - 1 for n in lens)
    seen = sum(n + t for n in lens for t in range(w))
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * live * h * d * 2
    bms, by = bound(nb, 4 * h * d * seen, "bfloat16")
    hkp, hvp, sets = paged_sets(gen, lens, (8, w, h, d), maxp, h, bf16)
    rows["paged_attention_varq [head_dim 128]"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.paged_attention_varq_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
        hbm_ms=device_ms(lambda q, bt: A.paged_attention_varq_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                         floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.paged_attention_varq_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by, library_ms=None, shape="q [8,5,16,128], lens 1..500, maxp 34",
    )
    del hkp, hvp, sets
    torch.cuda.synchronize()
    log("kernels at head_dim 128: within tolerance in bf16 and fp32; paged rows bitwise equal with tables of 32 "
        "and 128 pages and alone vs in the batch; verify slot t at W = 1, 5, 16 (bf16) and 3, 5, 16 (fp32) equals "
        "paged_attention at kv_lens + t bit for bit; head_dims 32/80 raise")
    for name, row in rows.items():
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms (SDPA)"
        hbm = f" warm, {row['hbm_ms']:.4f} ms from device memory" if "hbm_ms" in row else ""
        log(f"kernel {name} {row['shape']}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), kernel "
            f"{row['ms']:.4f} ms on the device{hbm}, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), library {lib}")
    return rows


#: the float16 rows of the kernel table (phase 23 serves them): flash at
#: the VLM vision tower's call, SVTR's widest (640 bucket) and the
#: Qwen2-MoE decoder's cacheless causal forward
FP16_FLASH_SHAPES = {"VLM vision": (1, 12, 256, 64, False), "OCR SVTR 640 bucket": (32, 4, 1920, 16, False),
                     "Qwen2-MoE cacheless forward": (1, 16, 265, 128, True)}
#: the decoders' (heads, KV heads) by head_dim: dense Qwen2-0.5B, Qwen2-MoE
DECODER_HEADS = {64: (14, 2), 128: (16, 16)}


def check_fp16(seed: int) -> dict:
    """Every float16 instance of the four attention kernels against its
    plain version (fp32 on the same float16 inputs), with ragged cases, at
    the shapes of the kernel table's bf16 rows, each timed beside its bound
    and beside SDPA in float16 (masked SDPA for the cache kernel; none for
    the paged kernels): flash <16>, <64>, <128>; the cache kernel's chunk
    q [1, H, 256, D] against 832 slots at <64> and <128>; paged q [8, H,
    D] at lengths 1..500 and the verify window W = 5 at <64> (14/2 heads:
    the tensor cores) and <128> (16/16: the FMA units). The paged plans of
    float16 equal bf16's (``lumen_paged_plan`` and ``ops.attention.
    paged_plan``), and the paged kernels keep their bitwise properties in
    float16 (verify slot t = decode at kv_lens + t, a row alone = the row
    in the batch, the table's width). Returns the rows for the kernel
    table."""
    import torch
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    f16, bf16 = torch.float16, torch.bfloat16

    def rnd(*shape, dtype=f16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def f32(*ts):
        return [t.float() for t in ts]

    rows = {}
    # flash_attention: ragged and causal cases at each head_dim (sk > sq
    # on the long path, lengths off the tiles), the CLIP towers' bulk calls
    errs = {16: [], 64: [], 128: []}
    for b, h, sq, sk, causal, d in (
        (1, 12, 100, 100, False, 64), (2, 14, 77, 77, True, 64), (1, 14, 50, 130, True, 64),
        (3, 2, 200, 64, False, 64), (2, 2, 129, 129, True, 64), (64, 12, 50, 50, False, 64),
        (64, 8, 77, 77, True, 64), (2, 4, 240, 240, False, 16), (2, 4, 240, 240, True, 16),
        (3, 4, 77, 77, False, 16), (8, 4, 960, 960, False, 16), (2, 16, 77, 77, False, 128),
        (1, 16, 50, 130, True, 128),
    ):
        q, k, v = rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d)
        errs[d].append(max_err(A.flash_attention(q, k, v, causal=causal),
                               A.attention_reference(*f32(q, k, v), causal=causal)))
    q, k, v = (rnd(64, 12, 50, 64) for _ in range(3))
    if not torch.equal(A.flash_attention(q[:1], k[:1], v[:1]), A.flash_attention(q, k, v)[:1]):
        raise AssertionError("flash_attention float16: a sequence's output changed with the batch it was launched in")
    for label, (b, h, s, d, causal) in FP16_FLASH_SHAPES.items():
        row = flash_row(rnd, f"float16 {label}", b, h, s, d, causal, plain_iters=10 if d == 16 else 20, dtype=f16)
        rows[f"flash_attention [float16, head_dim {d}]"] = dict(row, max_abs_err=max(errs[d] + [row["max_abs_err"]]))

    # flash_attention_cache: a caption prompt's two chunks, ragged batches,
    # kv_valid and offsets across the 64-key tile; the chunk timed
    slots = torch.arange(832, device=dev)
    for d, (h, _) in DECODER_HEADS.items():
        errs_c = []
        for b, sq, sk, offs, valid in ((1, 256, 832, [0], [256]), (1, 63, 832, [256], [265]),
                                       (2, 63, 832, [256, 37], [265, 100]), (1, 48, 832, [79], [127]),
                                       (4, 319, 832, [0] * 4, [319, 265, 270, 300]), (4, 16, 88, [0] * 4, [16] * 4)):
            q, k, v = rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d)
            qo = torch.tensor(offs, device=dev, dtype=torch.int32)
            kv = torch.tensor(valid, device=dev, dtype=torch.int32)
            errs_c.append(max_err(A.flash_attention_cache(q, k, v, qo, kv), A._decode_masked(*f32(q, k, v), qo, kv)))
        q, k, v = rnd(1, h, 256, d), rnd(1, h, 832, d), rnd(1, h, 832, d)
        qo = torch.tensor([0], device=dev, dtype=torch.int32)
        kv = torch.tensor([256], device=dev, dtype=torch.int32)
        bms, by = bound(2 * q.numel() * 2 + 2 * h * 256 * d * 2, 4 * h * d * (256 * 257 // 2), "float16")
        mask = ((slots[None, :] < 256) & (slots[None, :] <= torch.arange(256, device=dev)[:, None]))[None, None]
        rows[f"flash_attention_cache [float16, head_dim {d}]"] = dict(
            max_abs_err=max(errs_c),
            ms=device_ms(lambda: A.flash_attention_cache(q, k, v, qo, kv), 50, floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A._decode_masked(q, k, v, qo, kv), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50, floor_ms=bms),
            shape=f"q [1,{h},256,{d}] vs 832 slots, 256 live",
        )

    # paged_attention and the verify window, at both decoders' heads
    pages, page = 1025, 16

    def table(row_lens, maxp, w=1):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: len(row_lens) * maxp]
        bt = (perm.reshape(len(row_lens), maxp) + 1).to(torch.int32)
        for r, n in enumerate(row_lens):
            if r % 2:
                bt[r, -(-(n + w - 1) // page):] = 0  # dump page
        return bt

    for d, (h, kvh) in DECODER_HEADS.items():
        group = h // kvh
        for w in (1, 5, 16):
            # (blocks resident an SM follow each instance's registers: not the plan)
            plan16, plan_bf = (paged_plan_on_card(group, d, w, t) for t in (f16, bf16))
            if plan16.pop("resident") < 1 or plan_bf.pop("resident") < 1 or plan16 != plan_bf:
                raise AssertionError(f"paged plan of float16 (group {group}, head_dim {d}, W {w}) {plan16} differs "
                                     f"from bf16's {plan_bf}")
        kp, vp = rnd(pages, kvh, page, d), rnd(pages, kvh, page, d)
        lens = [1, 16, 17, 300, 333, 129, 64, 500]
        bt, kl = table(lens, 32), torch.tensor(lens, device=dev, dtype=torch.int32)
        q = rnd(8, h, d)
        out = A.paged_attention_kernel(q, kp, vp, bt, kl)
        errs_p = [max_err(out, A.paged_attention_reference(*f32(q, kp, vp), bt, kl))]
        span = A.paged_plan(group, d, 1, f16)["span"]
        edge = [span - 1, span, span + 1, 2048]
        bt_e, kl_e = table(edge, 128), torch.tensor(edge, device=dev, dtype=torch.int32)
        q_e = rnd(4, h, d)
        errs_p.append(max_err(A.paged_attention_kernel(q_e, kp, vp, bt_e, kl_e),
                              A.paged_attention_reference(*f32(q_e, kp, vp), bt_e, kl_e)))
        bt_wide = torch.zeros((8, 128), device=dev, dtype=torch.int32)
        bt_wide[:, :32] = bt
        if not torch.equal(A.paged_attention_kernel(q, kp, vp, bt_wide, kl), out):
            raise AssertionError(f"paged_attention float16 <{d}>: a row changed with the table padded to 128 pages")
        check_paged_bits(q, kp, vp, bt, kl, f"paged_attention float16 <{d}>")
        total = sum(lens)
        nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * total * kvh * d * 2
        bms, by = bound(nb, 4 * h * d * total, "float16")
        hkp, hvp, sets = paged_sets(gen, lens, (8, h, d), 32, kvh, f16)
        rows[f"paged_attention [float16, head_dim {d}]"] = dict(
            max_abs_err=max(errs_p),
            ms=device_ms(lambda: A.paged_attention_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
            hbm_ms=device_ms(lambda q, bt: A.paged_attention_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                             floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by, library_ms=None, shape=f"q [8,{h},{d}], lens 1..500, maxp 32",
            plan=paged_plan_text(q, kp, 32),
        )
        del hkp, hvp, sets

        errs_v, maxp = [], 34
        lens = [1, 16, 15, 300, 333, 129, 62, 500]
        kl = torch.tensor(lens, device=dev, dtype=torch.int32)
        cases = {}
        for w in (1, 5, 16):
            bt = table(lens, maxp, w)
            q = rnd(8, w, h, d)
            errs_v.append(max_err(A.paged_attention_varq_kernel(q, kp, vp, bt, kl),
                                  A.paged_attention_varq_reference(*f32(q, kp, vp), bt, kl)))
            check_paged_bits(q, kp, vp, bt, kl, f"paged_attention_varq float16 <{d}> W={w}")
            cases[w] = (q, bt)
        w = 5
        q, bt = cases[w]
        live = sum(n + w - 1 for n in lens)
        seen = sum(n + t for n in lens for t in range(w))
        nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * live * kvh * d * 2
        bms, by = bound(nb, 4 * h * d * seen, "float16")
        hkp, hvp, sets = paged_sets(gen, lens, (8, w, h, d), maxp, kvh, f16)
        rows[f"paged_attention_varq [float16, head_dim {d}]"] = dict(
            max_abs_err=max(errs_v),
            ms=device_ms(lambda: A.paged_attention_varq_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
            hbm_ms=device_ms(lambda q, bt: A.paged_attention_varq_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                             floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A.paged_attention_varq_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by, library_ms=None, shape=f"q [8,5,{h},{d}], lens 1..500, maxp 34",
            plan=paged_plan_text(q, kp, maxp),
        )
        del hkp, hvp, sets, kp, vp
    torch.cuda.synchronize()
    log("kernels in float16: every instance within tolerance of its plain version (fp32 on the same inputs); "
        "a CLIP row alone equals it in the batch of 64; the paged plans equal bf16's at W = 1, 5, 16; paged rows "
        "bitwise equal with tables of 32 and 128 pages and alone vs in the batch; verify slot t at W = 1, 5, 16 "
        "equals paged_attention at kv_lens + t bit for bit")
    for name, row in rows.items():
        lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms (SDPA, float16)"
        hbm = f" warm, {row['hbm_ms']:.4f} ms from device memory" if "hbm_ms" in row else ""
        plan = f"; plan {row['plan']}" if isinstance(row.get("plan"), str) else ""
        log(f"kernel {name} {row['shape']}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), kernel "
            f"{row['ms']:.4f} ms on the device{hbm}, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), library {lib}{plan}")
    return rows


def moe_routing(seed: int, tokens: int, dec, device) -> tuple:
    """A seeded router's top-k assignment of ``tokens`` tokens at the MoE
    decoder's widths, as ``parallel.moe`` sorts it: the order of the
    ``tokens * k`` rows and the group ends (int32, on the device)."""
    import torch

    from lumen_tpu_torch.parallel import moe as M

    gen = torch.Generator(device=device).manual_seed(seed)
    router = torch.randn((dec.hidden_size, dec.moe_experts), generator=gen, device=device) / dec.hidden_size ** 0.5
    x = torch.randn((tokens, dec.hidden_size), generator=gen, device=device)
    _, idx = M._topk_gates(x, router, dec.moe_top_k, dec.moe_norm_topk)
    e_flat = idx.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    ends = torch.bincount(e_flat, minlength=dec.moe_experts).cumsum(0).to(torch.int32)
    return x.repeat_interleave(dec.moe_top_k, 0)[order].contiguous(), ends, int(e_flat.unique().numel())


def check_grouped_mm(seed: int) -> dict:
    """The MoE grouped product's kernel in float16 and float32 against
    ``grouped_mm_reference`` (fp32 on the same inputs) at phase 15 (c)'s
    shapes (Qwen1.5-MoE-A2.7B: the gate bank [60, 2048, 1408] over 8
    tokens x top-4 = 32 sorted rows, and the down bank [60, 1408, 2048]),
    a prefill chunk's 256 tokens (1,024 rows), and a ragged case (empty
    groups, rows past the last end, K and M off the tiles); no
    device-to-host sync a call; the gate bank's call timed beside its byte
    bound (the chosen experts' matrices, x and the output once) and the
    plain per-group loop (CUDA events: it reads the ends on the host). No
    PyTorch call computes it on the card in these types without a host
    sync: library none. Returns the two rows for the kernel table."""
    import torch

    from lumen_tpu_torch.parallel import moe as M
    from lumen_tpu_torch.testing.vlm_standins import qwen15_moe_a27b

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    dec = qwen15_moe_a27b().decoder
    e, d, f = dec.moe_experts, dec.hidden_size, dec.moe_intermediate_size
    xs, ends, distinct = moe_routing(seed + 17, 8, dec, dev)
    xp, ends_p, _ = moe_routing(seed + 18, 256, dec, dev)
    rows = {}
    for dt in (torch.float16, torch.float32):
        name = str(dt).removeprefix("torch.")
        w_gate = (torch.randn((e, d, f), generator=gen, device=dev) / d ** 0.5).to(dt)
        w_down = (torch.randn((e, f, d), generator=gen, device=dev) / f ** 0.5).to(dt)
        x, h = xs.to(dt), torch.randn((xs.shape[0], f), generator=gen, device=dev).to(dt)
        errs = [max_err(M.grouped_mm(x, w_gate, ends), M.grouped_mm_reference(x.float(), w_gate.float(), ends)),
                max_err(M.grouped_mm(h, w_down, ends), M.grouped_mm_reference(h.float(), w_down.float(), ends)),
                max_err(M.grouped_mm(xp.to(dt), w_gate, ends_p),
                        M.grouped_mm_reference(xp.to(dt).float(), w_gate.float(), ends_p))]
        xr = torch.randn((15, 40), generator=gen, device=dev).to(dt)
        wr = torch.randn((5, 40, 24), generator=gen, device=dev).to(dt)
        ends_r = torch.tensor([0, 3, 3, 10, 12], device=dev, dtype=torch.int32)  # 3 rows past the last end
        out_r = M.grouped_mm(xr, wr, ends_r)
        errs.append(max_err(out_r, M.grouped_mm_reference(xr.float(), wr.float(), ends_r)))
        if bool(out_r[12:].any()):
            raise AssertionError(f"grouped_mm {name}: rows past the last group end are not zero")
        syncs = count_syncs(lambda: M.grouped_mm(x, w_gate, ends))
        if syncs:
            raise AssertionError(f"grouped_mm {name}: {syncs} device-to-host syncs a call (the ends stay on the card)")
        size = x.element_size()
        nb = distinct * d * f * size + x.numel() * size + x.shape[0] * f * size
        flops = 2 * x.shape[0] * d * f
        bms, by = bound(nb, flops, "float16") if dt == torch.float16 else (
            max(nb / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3, "bytes" if nb / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")
        rows[f"grouped_mm [{name}]"] = dict(
            max_abs_err=max(errs),
            ms=device_ms(lambda: M.grouped_mm(x, w_gate, ends), 50, floor_ms=bms, launches=1),
            plain_ms=cuda_ms(lambda: M.grouped_mm_reference(x, w_gate, ends), 10),
            bound_ms=bms, bound_by=by, library_ms=None, syncs=syncs,
            shape=f"gate bank, {x.shape[0]} sorted rows over {distinct} of {e} experts, [{e},{d},{f}] {name}",
        )
        r = rows[f"grouped_mm [{name}]"]
        log(f"kernel grouped_mm {name} ({r['shape']}): max|diff| {r['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|) over "
            f"the gate and down banks at 32 rows, 1,024 rows of a 256-token chunk and a ragged case (empty groups, rows "
            f"past the last end zero); 0 syncs a call; kernel {r['ms']:.4f} ms on the device, plain per-group loop "
            f"{r['plain_ms']:.4f} ms a call (CUDA events), bound {bms:.5f} ms ({by}: {nb} B at 3.35 TB/s), library none")
        del w_gate, w_down
    return rows


def kernel_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled symbol, with its integer
    template argument: ``_ZN5lumen27flash_attention_bf16_kernelILi64EE...``
    -> ``flash_attention_bf16_kernel<64>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[i:])) is not None:
        n = int(m[0])
        name = mangled[i + len(m[0]):i + len(m[0]) + n]
        i += len(m[0]) + n
    rest = mangled[i:]
    if targ := re.match(r"ILi(\d+)E", rest):
        return f"{name}<{targ[1]}>"
    # a type then an int (``paged_walk_kernel<__nv_bfloat16, 128>``, ``<float, 64>``), or a type
    # alone (``grouped_mm_kernel<__half>``)
    if targ := re.match(r"I(?:(\d+)|f)", rest):
        tname = rest[targ.end():targ.end() + int(targ[1])] if targ[1] else "float"
        after = rest[targ.end() + len(tname) * bool(targ[1]):]
        if d := re.match(r"Li(\d+)E", after):
            return f"{name}<{tname}, {d[1]}>"
        if after.startswith("E"):
            return f"{name}<{tname}>"
    return name


def ptxas_report(logs: dict) -> list[dict]:
    """Registers, shared memory and spills of every kernel function, from
    the ``-Xptxas -v`` logs of the build (one entry per library)."""
    report = []
    for lib, text in logs.items():
        func, spill = None, (0, 0)
        for line in text.splitlines():
            if "Compiling entry function" in line:
                func = kernel_name(line.split("'")[1])
            elif "spill stores" in line:
                n = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                spill = (int(n[0]), int(n[1]))
            elif "Used" in line and "registers" in line and func:
                smem = re.search(r"(\d+) bytes smem", line)
                report.append(dict(lib=lib, func=func, registers=int(re.search(r"Used (\d+) registers", line)[1]),
                                   smem=int(smem[1]) if smem else 0, spill_stores=spill[0], spill_loads=spill[1]))
                func, spill = None, (0, 0)
    return report


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        import triton

        path = str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    return path


def hmma_counts(kernels) -> dict:
    """HMMA (tensor-core matrix multiply) instructions per kernel function
    in each library's SASS, from ``cuobjdump -sass``."""
    tool = cuobjdump()
    counts = {}
    for k in kernels:
        sass = subprocess.run([tool, "-sass", str(k.library_path())], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        func = None
        for line in sass.splitlines():
            if "Function :" in line:
                func = kernel_name(line.split("Function :")[1].strip())
                counts[func] = 0
            elif func and "HMMA" in line:
                counts[func] += 1
    return counts


def check_varq(seed: int) -> dict:
    """paged_attention_varq: 8 rows over the 1025-page pool at W = 1, 5
    (the smoke drive's K = 4) and 16 (K = 15, the most the engine takes);
    ragged lengths, windows crossing page and span boundaries, tables
    padded with the dump page and stale ids, in bf16 and fp32. Verify slot
    t must equal the single-token kernel at kv_lens + t bit for bit, and a
    row alone the same row in the batch. Times W = 5 (the table's row) and
    W = 16, warm and from device memory."""
    import torch

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    bf16 = torch.bfloat16
    pages, page, maxp = 1025, 16, 34
    kp = torch.randn((pages, 2, page, 64), generator=gen, device=dev).to(bf16)
    vp = torch.randn((pages, 2, page, 64), generator=gen, device=dev).to(bf16)
    kpf, vpf = kp.float(), vp.float()
    lens = [1, 16, 15, 300, 333, 129, 62, 500]  # 15 + W and 62 + W cross a page edge, 62 + W the span's
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    errs = []
    cases = {}
    for w in (1, 5, 16):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: 8 * maxp].reshape(8, maxp) + 1
        bt = perm.to(torch.int32)
        for r, n in enumerate(lens):
            if r % 2:
                bt[r, -(-(n + w - 1) // page):] = 0  # dump page past the window's last page
        q = torch.randn((8, w, 14, 64), generator=gen, device=dev).to(bf16)
        out = A.paged_attention_varq_kernel(q, kp, vp, bt, kl)
        ref = A.paged_attention_varq_reference(q.float(), kpf, vpf, bt, kl)
        errs.append(max_err(out, ref))
        check_paged_bits(q, kp, vp, bt, kl, f"paged_attention_varq W={w}")
        if w > 1:  # the fp32 instance
            qf = q.float()
            errs.append(max_err(A.paged_attention_varq_kernel(qf, kpf, vpf, bt, kl), ref))
            check_paged_bits(qf, kpf, vpf, bt, kl, f"paged_attention_varq fp32 W={w}")
        cases[w] = (q, bt)
    torch.cuda.synchronize()
    log("kernel paged_attention_varq: verify slot t at W = 1, 5, 16 equals paged_attention at kv_lens + t bit for "
        "bit, and a row alone the same row in the batch, in bf16 and fp32 (W = 5, 16)")
    timed = {}
    for w in (5, 16):
        q, bt = cases[w]
        live = sum(n + w - 1 for n in lens)  # K/V slots some window slot reads
        seen = sum(n + t for n in lens for t in range(w))  # (slot, key) pairs
        nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * live * 2 * 64 * 2
        bms, by = bound(nb, 4 * 14 * 64 * seen, "bfloat16")
        hkp, hvp, sets = paged_sets(gen, lens, (8, w, 14, 64), maxp, 2, bf16)
        timed[w] = dict(
            ms=device_ms(lambda: A.paged_attention_varq_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
            hbm_ms=device_ms(lambda q, bt: A.paged_attention_varq_kernel(q, hkp, hvp, bt, kl), 100, args=sets,
                             floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A.paged_attention_varq_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by, nb=nb, flops=4 * 14 * 64 * seen,
        )
        del hkp, hvp, sets
        r = timed[w]
        log(f"kernel paged_attention_varq (W={w}): kernel {r['ms']:.4f} ms on the device warm, {r['hbm_ms']:.4f} ms "
            f"from device memory, plain {r['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by}: {nb} B / 3.35 TB/s vs "
            f"{r['flops']} flop / 989 TFLOP/s), library none; plan {paged_plan_text(q, kp, maxp)}; fp32 plan "
            f"{paged_plan_text(q.float(), kp, maxp)}")
    r = timed[5]
    return dict(max_abs_err=max(errs), ms=r["ms"], hbm_ms=r["hbm_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, shape="8 rows, W=5, 14/2 heads")


def check_w8a16(seed: int, q8_shapes: dict = Q8_SHAPES, main: str = "gate_proj/up_proj") -> dict:
    """w8a16_matmul at every projection shape of the int8 decoder
    (``q8_shapes``: Qwen2-0.5B's, or the Qwen2-MoE decoder's): rows 1, 3,
    8 (decode), 40 (a W = 5 verify window over 8 slots) and 64 (the
    routing limit) against the plain version; the first 8 rows of a
    40-row call must equal an 8-row call bit for bit. Times at 8 and 40
    rows, with weights cycled past the L2 as a decode step finds them.
    Returns the ``main`` row at 8 rows for the kernel table, the other
    shapes under ``shapes``."""
    import torch

    from lumen_tpu_torch.ops import quant_matmul as QM

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    bf16 = torch.bfloat16
    x40 = x64 = None
    try:  # the yardstick call exists on the card's torch only if it has a CUDA kernel
        probe = torch.zeros((8, 64), device=dev, dtype=bf16)
        torch._weight_int8pack_mm(probe, torch.zeros((64, 64), device=dev, dtype=torch.int8),
                                  torch.ones(64, device=dev, dtype=bf16))
        int8pack = True
    except (RuntimeError, NotImplementedError) as e:
        log(f"w8a16 library yardstick: torch._weight_int8pack_mm has no CUDA kernel here ({type(e).__name__})")
        int8pack = False
    shapes = {}
    errs = []
    for name, (k, n) in q8_shapes.items():
        parts = QM.w8a16_parts(k, n)
        lib_parts = QM.W8A16.query("lumen_w8a16_parts", k, n)
        if lib_parts != parts:
            raise AssertionError(f"w8a16_matmul {name}: the library splits K in {lib_parts}, the mirror in {parts}")
        copies = max(2, -(-64 * 2**20 // (k * n)))  # int8 copies > 64 MB: past the 50 MB L2
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8) for _ in range(copies)]
        scales = [torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4 for _ in range(copies)]
        q, scale = qs[0], scales[0]
        for rows in (1, 3, 8, 40, 64):
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf16)
            out = QM.w8a16_matmul(x, q, scale)
            errs.append(max_err(out, QM.w8a16_reference(x.float(), q, scale)))
            if rows == 40:
                x40 = x
            if rows == 64:
                x64 = x
        head = QM.w8a16_matmul(x40[:8].contiguous(), q, scale)
        if not torch.equal(QM.w8a16_matmul(x40, q, scale)[:8], head):
            raise AssertionError(f"w8a16_matmul {name}: rows of a 40-row call differ from an 8-row call")
        if not torch.equal(QM.w8a16_matmul(x64, q, scale)[:1], QM.w8a16_matmul(x64[:1].contiguous(), q, scale)):
            raise AssertionError(f"w8a16_matmul {name}: the first row of a 64-row call differs from a 1-row call")
        for rows in (8, 40):
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf16)
            args = list(zip([x] * copies, qs, scales))
            nb = rows * k * 2 + k * n + n * 4 + rows * n * 2
            fl = 2 * rows * k * n
            bms, by = bound(nb, fl, "bfloat16")
            wbf = [(x, qq.to(bf16)) for qq in qs]
            bf16_bound, _ = bound(nb + k * n, fl, "bfloat16")  # the yardstick reads bf16 weights
            packs = [(x, qq.T.contiguous(), ss.to(bf16)) for qq, ss in zip(qs, scales)] if int8pack else None
            shapes[f"{name} {rows}x{k}x{n}"] = dict(
                parts=parts, blocks=QM.w8a16_grid(rows, k, n),
                ms=device_ms(QM.w8a16_matmul, 100, args, floor_ms=bms, launches=1),
                plain_ms=device_ms(QM.w8a16_reference, 20, args, floor_ms=bms),
                bound_ms=bms, bound_by=by, bound_formula=f"{nb} B / 3.35 TB/s vs {fl} flop / 989 TFLOP/s",
                library_ms=device_ms(torch._weight_int8pack_mm, 100, packs, floor_ms=bms) if packs else None,
                bf16_matmul_ms=device_ms(torch.matmul, 100, wbf, floor_ms=bf16_bound, strict=False),
            )
            if (name, rows) == (main, 8):
                # Once: a call's cost with the host's launch path (CUDA
                # events), which sets the price at decode sizes.
                call_ms = cuda_ms(lambda: QM.w8a16_matmul(*args[0]), 100)
                log(f"kernel w8a16_matmul {name} 8x{k}x{n}: {call_ms:.4f} ms a call, launch path included")
            del wbf, packs
        del qs, scales
    torch.cuda.synchronize()
    log("kernel w8a16_matmul: rows 1/3/8/40/64 at every projection shape within tolerance; "
        "the first 8 rows of a 40-row call equal an 8-row call and the first row of a 64-row call "
        "a 1-row call, bit for bit")
    c = QM.w8a16_constants()
    for shape, r in shapes.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        yard = "not valid" if r["bf16_matmul_ms"] is None else f"{r['bf16_matmul_ms']:.4f} ms"
        tiles, parts, z, rt = r["blocks"]
        log(f"kernel w8a16_matmul {shape}: kernel {r['ms']:.4f} ms on the device "
            f"(K split in {parts}, {tiles * parts * z} blocks = {tiles} column tiles x {parts} parts x {z}, "
            f"{rt} row tile(s) a block, {c['stages'] if rt == 1 else c['stages_wide']} x {c['depth']}-deep "
            f"stages, no workspace), "
            f"plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bound_formula']}), "
            f"library (_weight_int8pack_mm) {lib}, yardstick bf16 torch.matmul {yard}")
    k, n = q8_shapes[main]
    row = dict(shapes[f"{main} 8x{k}x{n}"], max_abs_err=max(errs), shape=f"{main} 8x{k}x{n}")
    row["shapes"] = shapes
    return row


# -- shared: a word-level tokenizer with the HF tokenizers interface --------


class _Encoding:
    def __init__(self, ids):
        self.ids = ids


class WordTokenizer:
    """Whitespace word-level tokenizer: known words map to fixed ids, any
    other word to a stable id in [1000, vocab - 1000); decode prints ids
    as words."""

    def __init__(self, vocab_size: int, special: dict[str, int]):
        self.vocab_size = vocab_size
        self.special = special

    def _id(self, word: str) -> int:
        if word in self.special:
            return self.special[word]
        h = 0
        for ch in word.encode():
            h = (h * 131 + ch) % 1_000_003
        return 1000 + h % (self.vocab_size - 2000)

    def encode(self, text: str, add_special_tokens: bool = False) -> _Encoding:
        return _Encoding([self._id(w) for w in text.split()])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"w{i}" for i in ids)


# -- phase 3: small fp32 reference ------------------------------------------


def check_reference(seed: int) -> None:
    """A small fp32 VLM (head_dim 64, so every kernel takes it) served on
    the card and on the CPU from the same weights: same greedy tokens; and
    on the card with speculative decoding (K = 4): the same tokens again,
    through verify turns (in fp32 QDense would take its matmul branch, so
    the w8a16 kernel is held in phase 2)."""
    import dataclasses

    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_

    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=256, layers=2, heads=4, kv_heads=2,
            intermediate_size=512, vocab_size=4096, rope_theta=10_000.0,
        ),
        vision=dataclasses.replace(base.vision, image_size=256, patch_size=32, width=128, layers=2, heads=2),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    model = init_random_(VLMModel(cfg), seed)
    tok = WordTokenizer(cfg.decoder.vocab_size, {})
    rng = np.random.default_rng(seed)
    pixels = [rng.integers(0, 256, (256, 256, 3), np.uint8) for _ in range(2)]
    msgs = [[ChatMessage("user", f"describe picture {i} briefly")] for i in range(2)]
    from lumen_tpu_torch.ops.attention import PAGED_VARQ

    outs = {}
    for run, device, spec in (("card", "cuda:0", "0"), ("cpu", "cpu", "0"), ("card+spec", "cuda:0", "4")):
        with env(LUMEN_VLM_SPEC_K=spec, LUMEN_VLM_SPEC_MIN_RATE="0"):
            mgr = VLMManager(
                cfg, model.state_dict(), tok, device=device, dtype="float32", max_seq=256,
                max_new_cap=24, prefill_buckets=(16, 32), pool_pages=33, prefill_chunk=32,
            )
        try:
            PAGED_VARQ.launches = 0
            outs[run] = [mgr.generate(m, p, max_new_tokens=24).tokens for m, p in zip(msgs, pixels)]
            if spec != "0":
                eng = mgr.engine
                if eng.spec_turns == 0 or PAGED_VARQ.launches == 0:
                    raise AssertionError(
                        f"speculative run took {eng.spec_turns} verify turns, "
                        f"{PAGED_VARQ.launches} verify-window launches"
                    )
                log(f"reference: spec K=4 took {eng.spec_turns} verify turns, "
                    f"{eng.spec_accepted}/{eng.spec_proposed} drafted tokens accepted, "
                    f"{PAGED_VARQ.launches} paged_attention_varq launches")
        finally:
            mgr.close()
    if not outs["card"] == outs["cpu"] == outs["card+spec"]:
        raise AssertionError(f"card, CPU and card with speculation disagree: {outs}")
    log(f"reference: small fp32 VLM, card == CPU == card with speculation, greedy tokens "
        f"({[len(t) for t in outs['cpu']]} tokens)")


# -- phases 4 and 5: the serving path at full width -------------------------


def drive_serving(
    seed: int, card: str, cfg=None, device: str = "cuda:0", quantize: str | None = None,
    spec_k: int = 0, kernels: tuple = PHASE4_KERNELS, state: dict | None = None, label: str | None = None,
    dtype: str = "bfloat16", sampled: int = 0,
) -> dict:
    """Phase 4 (defaults) or phase 5 (``quantize="int8"``, ``spec_k=4``):
    10 caption requests, 8 at once and 2 after decoding started, three of
    them streaming. Returns the drive's numbers, with every kernel's launch
    count during the drive under ``launches`` (by head_dim under
    ``instances``). ``cfg``/``device`` let the CPU tests rehearse the drive
    at a small configuration (it then stops at the launch-count check:
    plain paths launch nothing). ``state`` serves given weights (phase
    15's MoE model, made once on the card) instead of seeding a model, in
    ``dtype``; ``sampled`` sampled requests follow the greedy repeat, alone
    (a sampled row never drafts: with speculation on they decode through
    the single-token kernel)."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.ops.quant import QDense

    label = label or f"phase {5 if quantize or spec_k else 4}"
    cfg = cfg or VLMConfig()
    t0 = time.perf_counter()
    if state is None:
        with torch.device(device):
            model = VLMModel(cfg)
        init_random_(model, seed)
        state = model.to(torch.bfloat16).state_dict()
        del model
    tok = WordTokenizer(cfg.decoder.vocab_size, {})
    with env(LUMEN_VLM_SPEC_K=str(spec_k), LUMEN_VLM_SPEC_MIN_RATE="0"):
        mgr = VLMManager(
            cfg, state, tok, device=device, dtype=dtype, max_seq=2048,
            gen_slots=8, gen_block=8, page_size=16, pool_pages=8 * 2048 // 16 + 1, prefill_chunk=256,
            quantize=quantize,
        )
    del state  # the int8 model must not sit beside a bf16 copy of its projections
    log(f"{label}: {'Qwen2-MoE' if cfg.decoder.moe_experts else 'VLMConfig()'} ({dtype}, quantize={quantize}, "
        f"spec K={spec_k}) built in {time.perf_counter() - t0:.1f} s, kv {mgr.kv_layout()}")
    if quantize:
        dec = mgr.model.decoder
        d = cfg.decoder
        qd = [m for m in dec.modules() if isinstance(m, QDense)]
        # Attention's four projections a layer, a SwiGLU's three (a MoE
        # layer's shared expert), an untied lm_head; a MoE router,
        # shared_gate and expert banks stay float (the JAX lockstep list).
        want = sum(4 + (3 if not d.is_moe_layer(i) or d.moe_shared_intermediate else 0) for i in range(d.layers))
        want += 0 if d.tie_word_embeddings else 1
        linear = [n for n, m in dec.named_modules() if isinstance(m, torch.nn.Linear) and not n.endswith("shared_gate")]
        if len(qd) != want or linear or any(m.q.dtype != torch.int8 for m in qd):
            raise AssertionError(f"int8 decoder: {len(qd)} QDense (want {want}), float projections {linear[:3]}")
        if any(m.scale.dtype != torch.float32 for m in qd):
            raise AssertionError("int8 decoder: a scale lost its fp32")
        log(f"{label}: all {len(qd)} decoder projections hold int8 q and fp32 scale")
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def request(i: int):
        pixels = rng.integers(0, 256, (size, size, 3), np.uint8)
        if spec_k:  # templated traffic: the repeated phrase prompt lookup serves
            text = f"Caption image {i}: a red car on a wet road, a red car on a wet road, a red car on a wet road."
        else:
            text = f"Describe image {i} in one detailed sentence."
        # (budgets of 16-48 tokens: the drive's checks need decoding under
        # way when the late requests arrive, not long answers)
        return [ChatMessage("user", text)], pixels, 16 + 4 * (i % 9)

    all_k = all_kernels()
    try:
        # Warm-up (cuBLAS handles, allocator), not counted.
        m, p, _ = request(99)
        mgr.generate(m, p, max_new_tokens=4)
        sync()
        reqs = [request(i) for i in range(10)]
        results: dict[int, dict] = {}
        errors: list[BaseException] = []

        def run(i: int, stream: bool):
            m, p, n = reqs[i]
            try:
                t = time.perf_counter()
                if stream:
                    chunks = list(mgr.generate_stream(m, p, max_new_tokens=n))
                    meta = chunks[-1].metadata
                    results[i] = dict(n=meta["generated_tokens"], budget=n, ttft_ms=meta.get("ttft_ms"),
                                      tokens=None, s=time.perf_counter() - t)
                else:
                    r = mgr.generate(m, p, max_new_tokens=n)
                    results[i] = dict(n=len(r.tokens), budget=n, tokens=r.tokens, finish=r.finish_reason,
                                      s=time.perf_counter() - t)
            except BaseException as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(e)

        eng = mgr.engine
        turns0, prop0, acc0 = eng.spec_turns, eng.spec_proposed, eng.spec_accepted
        blocks0 = eng.blocks_run
        for k in all_k:
            k.zero_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        stream_ids = {6, 7, 9}
        threads = [threading.Thread(target=run, args=(i, i in stream_ids)) for i in range(8)]
        for t in threads:
            t.start()
        # Late admissions: wait until decoding has started.
        deadline = time.perf_counter() + 300
        while eng.blocks_run == blocks0 and time.perf_counter() < deadline and not errors:
            time.sleep(0.005)
        if eng.blocks_run == blocks0:
            raise AssertionError("decoding never started")
        late = [threading.Thread(target=run, args=(i, i in stream_ids)) for i in (8, 9)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        launches = {k.name: k.launches for k in all_k}
        instances = {k.name: dict(k.instance_launches) for k in all_k}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        turns, prop, acc = eng.spec_turns - turns0, eng.spec_proposed - prop0, eng.spec_accepted - acc0
        if errors:
            raise errors[0]
        if len(results) != 10:
            raise AssertionError(f"only {len(results)} of 10 requests answered")
        for i, r in results.items():
            if not 1 <= r["n"] <= r["budget"]:
                raise AssertionError(f"request {i}: {r['n']} tokens for a budget of {r['budget']}")
            if r["tokens"] is not None and not all(0 <= t < cfg.decoder.vocab_size for t in r["tokens"]):
                raise AssertionError(f"request {i}: token id out of range")
        if spec_k and (turns == 0 or prop == 0):
            raise AssertionError(f"speculation never verified: {turns} verify turns, {prop} proposals")
        missing = [name for name in kernels if launches[name] == 0]
        if missing:
            raise AssertionError(f"serving path never launched: {missing} (launches {launches})")
        total = sum(r["n"] for r in results.values())
        ttfts = sorted(r["ttft_ms"] for r in results.values() if r.get("ttft_ms") is not None)
        log(f"{label}: 10 requests (8 at once, 2 after decoding started; {len(stream_ids)} streaming), "
            f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tok/s aggregate [{card}]")
        log(f"{label}: ttft_ms of streams {ttfts} [{card}]")
        log(f"{label}: peak device memory {peak / 2**30:.3f} GiB [{card}]")
        if spec_k:
            log(f"{label}: {turns} verify turns, {acc}/{prop} drafted tokens accepted "
                f"(rate {acc / prop:.3f})")
        log(f"{label}: launches {json.dumps(launches)}; decode turns {eng.blocks_run - blocks0}, "
            f"chunks {eng.chunks_run}, preemptions {eng.preemptions}")
        # Greedy determinism: request 0 again, alone.
        m, p, n = reqs[0]
        again = mgr.generate(m, p, max_new_tokens=n).tokens
        if again != results[0]["tokens"]:
            raise AssertionError("greedy request repeated gave different tokens")
        log(f"{label}: greedy repeat gives identical tokens")
        for i in range(sampled):
            m, p, _ = reqs[i]
            r = mgr.generate(m, p, max_new_tokens=8, temperature=0.8, do_sample=True)
            if not 1 <= len(r.tokens) <= 8:
                raise AssertionError(f"{label}: sampled request {i} gave {len(r.tokens)} tokens")
        stats = eng.kv.stats()
        if stats.pages_live != 0:
            raise AssertionError(f"pages still live after drain: {stats}")
        return dict(
            launches=launches, instances=instances, tokens=total, wall_s=wall, tok_s=total / wall, ttft_ms=ttfts,
            peak_gib=peak / 2**30, spec_turns=turns, spec_proposed=prop, spec_accepted=acc,
        )
    finally:
        mgr.close()


# -- phase 6: the gRPC server from a model directory ---------------------------


def deployment_yaml(path: Path, cache_dir: Path, model: str, quantize: str | None, extra: dict | None = None) -> Path:
    """A single-service deployment naming the service in its JAX form, which
    the port's loader maps onto its own class; ``extra`` adds backend
    settings (``warmup``, ``scheduler``)."""
    settings = {"dtype": "bfloat16", "batch_size": 8, **(extra or {})}
    if quantize:
        settings["quantize"] = quantize
    import yaml

    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "single", "service": "vlm"},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": settings,
            "models": {"vlm": {"model": model, "runtime": "jax"}},
        }},
    }))
    return path


def photo_jpeg(seed: int, width: int = 1600, height: int = 1200) -> bytes:
    """A seeded photo-sized JPEG (smooth gradients plus noise), not of the
    canvas size, so the server's letterbox resize runs."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1) * rng.uniform(80, 200, 3)
    img = np.clip(base + rng.normal(0, 12, (height, width, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def grpc_call(stub, task: str, payload: bytes, meta: dict, timeout: float = 600, mime: str = "image/jpeg") -> dict:
    """One Infer stream: its deltas, the final body (or error code), the
    final's meta and the client-side time to the first delta."""
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb

    req = pb.InferRequest(correlation_id="c", task=task, payload=bytes(payload), payload_mime=mime,
                          meta={k: str(v) for k, v in meta.items()})
    t0 = time.perf_counter()
    deltas, first, last = [], None, None
    for resp in stub.Infer(iter([req]), timeout=timeout):
        if not resp.is_final:
            first = first or time.perf_counter()
            deltas.append(resp.result)
        last = resp
    if last is None:
        raise AssertionError(f"{task}: the stream ended without a final message")
    out = dict(deltas=deltas, ttft_ms=None if first is None else (first - t0) * 1e3, s=time.perf_counter() - t0,
               code=last.error.code if last.HasField("error") else 0, mime=last.result_mime, meta=dict(last.meta))
    if not out["code"]:
        out["body"] = json.loads(last.result)
    return out


def boot_server(yaml_path: Path, device: str, metrics_port: int | None = None):
    """``serve()`` in process on an OS-assigned port; returns the handle,
    a stub and the seconds from the call to the first ``Health`` that
    answers ok."""
    import grpc
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t0 = time.perf_counter()
    handle = serve(load_config(str(yaml_path)), port_override=0, skip_download=True, device=device,
                   metrics_port=metrics_port)
    channel = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    stub = InferenceStub(channel)
    while True:
        try:
            stub.Health(empty_pb2.Empty(), timeout=10)
            break
        except grpc.RpcError:
            if time.perf_counter() - t0 > 300:
                raise
            time.sleep(0.05)
    return handle, channel, stub, time.perf_counter() - t0


def drive_grpc(seed: int, card: str, cfg=None, device: str = "cuda:0", root: Path | None = None) -> dict:
    """Phase 6: a full-width model directory served over real gRPC by the
    port's ``serve()``; bf16, then int8 with speculation. ``cfg``/``device``
    let the CPU tests rehearse it at a small configuration (it then stops at
    the launch-count check). The model directory goes under ``root`` (a
    temporary directory of its own when None), where phase 7 reads it
    again; the returned dict carries what phase 7 holds its answers to."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.models.vlm.chat import VlmTokenizer
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.testing.vlm_standins import hf_config, write_model_dir
    from lumen_tpu_torch.utils.host_decode import vlm_canvas
    from lumen_tpu_torch.utils.metrics import metrics

    cfg = cfg or VLMConfig()
    on_card = torch.device(device).type == "cuda"
    if VLMConfig.from_hf(hf_config(cfg)) != cfg:
        raise AssertionError("config.json does not read back as the served configuration")
    all_k = all_kernels()
    out: dict = {}
    with contextlib.ExitStack() as stack:
        if root is None:
            root = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="lumen-chip-smoke-")))
        t0 = time.perf_counter()
        with torch.device(device):
            model = VLMModel(cfg)
        init_random_(model, seed + 6)
        state = model.to(torch.bfloat16).state_dict()
        del model
        model_dir = write_model_dir(root / "cache", "SmokeVLM", cfg, state)
        state = {k: v.cpu() for k, v in state.items()}  # for the direct manager; off the card meanwhile
        mb = sum(f.stat().st_size for f in model_dir.iterdir()) / 2**20
        log(f"phase 6: model directory of VLMConfig() (seeded bf16 weights, HF names) written in "
            f"{time.perf_counter() - t0:.1f} s, {mb:.0f} MiB: {sorted(f.name for f in model_dir.iterdir())}")
        prompt = json.dumps([{"role": "user", "content": "describe this photo in one detailed sentence"}])
        photos = [photo_jpeg(seed * 100 + i) for i in range(12)]

        # -- bf16 server: 10 streams, 8 in flight at once -----------------
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with env(LUMEN_VLM_SPEC_K="0"):
            handle, channel, stub, load_s = boot_server(
                deployment_yaml(root / "bf16.yaml", root / "cache", "SmokeVLM", None), device)
        try:
            mgr = handle.services["vlm"].manager
            log(f"phase 6: bf16 server up in {load_s:.2f} s (serve() to the first Health ok), port "
                f"{handle.port}, {type(handle.services['vlm']).__module__}, kv {mgr.kv_layout()}")
            budgets = [32 + 4 * i for i in range(10)]
            for k in all_k:
                k.launches = 0
            t_start = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                streams = list(pool.map(lambda i: grpc_call(
                    stub, "vlm_generate_stream", photos[i], {"messages": prompt, "max_new_tokens": budgets[i]}),
                    range(10)))
            wall = time.perf_counter() - t_start
            unary = grpc_call(stub, "vlm_generate", photos[10], {"messages": prompt, "max_new_tokens": 16})
            launches = {k.name: k.launches for k in all_k}
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
            stub.Health(empty_pb2.Empty(), timeout=30)
            bad = grpc_call(stub, "vlm_generate_stream", b"\xff\xd8 not a jpeg", {"messages": prompt})
            for i, r in enumerate(streams + [unary]):
                if r["code"] or "text_generation" not in r["mime"]:
                    raise AssertionError(f"request {i}: no TextGenerationV1 final (code {r['code']}, {r['mime']})")
                body, budget = r["body"], (budgets + [16])[i]
                if not 1 <= body["generated_tokens"] <= budget:
                    raise AssertionError(f"request {i}: {body['generated_tokens']} tokens for a budget of {budget}")
                if i < 10 and b"".join(r["deltas"]).decode() != body["text"]:
                    raise AssertionError(f"stream {i}: deltas do not join to the final text")
            if bad["code"] != pb.ERROR_CODE_INVALID_ARGUMENT:
                raise AssertionError(f"a malformed image answered code {bad['code']}, not INVALID_ARGUMENT")
            if {t.name for t in caps.tasks} != {"vlm_generate", "vlm_generate_stream"} or caps.runtime != (
                    "torch-cuda" if on_card else "torch-cpu"):
                raise AssertionError(f"capabilities: {[t.name for t in caps.tasks]}, runtime {caps.runtime}")
            missing = [n for n in PHASE4_KERNELS if launches[n] == 0]
            if missing:
                raise AssertionError(f"the bf16 server never launched: {missing} (launches {launches})")
            tokens = sum(r["body"]["generated_tokens"] for r in streams)
            ttfts = [round(r["ttft_ms"], 2) for r in streams]
            log(f"phase 6: 10 vlm_generate_stream over gRPC (8 in flight, 1600x1200 JPEG each), {tokens} tokens "
                f"in {wall:.3f} s = {tokens / wall:.1f} tok/s aggregate [{card}]")
            log(f"phase 6: client-side ttft_ms (first delta) {ttfts}; server ttft_ms "
                f"{[r['body']['metadata'].get('ttft_ms') for r in streams]} [{card}]")
            log(f"phase 6: vlm_generate {unary['body']['generated_tokens']} tokens in {unary['s']:.3f} s; "
                f"GetCapabilities {caps.runtime} {sorted(t.name for t in caps.tasks)}; Health ok; malformed "
                f"image INVALID_ARGUMENT")
            log(f"phase 6: peak device memory {peak / 2**30:.3f} GiB [{card}]")
            log(f"phase 6: bf16 launches {json.dumps(launches)}")
            decode_ms = []
            for _ in range(5):
                t = time.perf_counter()
                vlm_canvas(photos[0], cfg.vision.image_size)
                decode_ms.append((time.perf_counter() - t) * 1e3)
            gap = [r["ttft_ms"] - r["body"]["metadata"]["ttft_ms"] for r in streams]
            task = metrics.snapshot()["tasks"]["vlm_generate_stream"]
            log(f"phase 6: service layer: host decode + letterbox of one 1600x1200 JPEG "
                f"{sorted(decode_ms)[2]:.1f} ms (median of 5, idle server); client ttft - server ttft "
                f"{min(gap):.1f}..{max(gap):.1f} ms (gRPC, dispatch, parse; the decode is inside the server's); server-side "
                f"vlm_generate_stream latency p50 {task['p50_ms']:.0f} ms (histogram bucket) over "
                f"{task['count']} streams [{card}]")
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out.update(load_s=load_s, tokens=tokens, wall_s=wall, tok_s=tokens / wall, ttft_ms=ttfts,
                   peak_gib=peak / 2**30, launches=launches, model_dir=model_dir, photos=photos, prompt=prompt,
                   budgets=budgets, streams=[r["body"] for r in streams], unary=unary["body"])

        # -- loading is lossless: request 0 on a manager built from `state` --
        direct = VLMManager(cfg, state, VlmTokenizer.from_model_dir(str(model_dir)), device=device,
                            dtype="bfloat16", gen_slots=8, gen_block=8)
        try:
            r = direct.generate([ChatMessage("user", "describe this photo in one detailed sentence")],
                                vlm_canvas(photos[0], cfg.vision.image_size), max_new_tokens=budgets[0])
            want = direct.tokenizer.decode(r.tokens)
        finally:
            direct.close()
        got = streams[0]["body"]
        if (got["generated_tokens"], got["text"]) != (len(r.tokens), want):
            raise AssertionError(f"request 0 over gRPC differs from the direct manager: "
                                 f"{got['generated_tokens']} tokens {got['text'][:80]!r} vs {len(r.tokens)} {want[:80]!r}")
        log(f"phase 6: request 0 == a direct VLMManager on the same weights and canvas ({len(r.tokens)} tokens)")
        del state

        # -- int8 server with speculation: 4 templated requests ---------------
        if on_card:
            torch.cuda.empty_cache()
        with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0"):
            handle, channel, stub, load8_s = boot_server(
                deployment_yaml(root / "int8.yaml", root / "cache", "SmokeVLM", "int8"), device)
        try:
            eng = handle.services["vlm"].manager.engine
            templated = json.dumps([{"role": "user", "content":
                                     "caption this image : a red car on a wet road , a red car on a wet road ."}])
            for k in all_k:
                k.launches = 0
            turns0 = eng.spec_turns
            with ThreadPoolExecutor(max_workers=4) as pool:
                q8 = list(pool.map(lambda i: grpc_call(
                    stub, "vlm_generate_stream", photos[11 - i % 2], {"messages": templated, "max_new_tokens": 48}),
                    range(4)))
            launches8 = {k.name: k.launches for k in all_k}
            if any(r["code"] for r in q8):
                raise AssertionError(f"int8 server: codes {[r['code'] for r in q8]}")
            missing = [n for n in PHASE6_INT8_KERNELS if launches8[n] == 0]
            if missing or eng.spec_turns == turns0:
                raise AssertionError(f"the int8 server never launched {missing} "
                                     f"({eng.spec_turns - turns0} verify turns; launches {launches8})")
            log(f"phase 6: int8 + spec K=4 server up in {load8_s:.2f} s; 4 templated streams, "
                f"{sum(r['body']['generated_tokens'] for r in q8)} tokens, {eng.spec_turns - turns0} verify turns; "
                f"launches {json.dumps(launches8)}")
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out.update(load8_s=load8_s, launches8=launches8)
    return out


# -- phase 7: the JAX server's default serving path -----------------------------

#: phase 7's prefix-cache budget (``LUMEN_VLM_PREFIX_BYTES``)
PHASE7_PREFIX_BYTES = 64 << 20
#: the questions phase 7 asks of one photo (prefix reuse)
QUESTIONS = ("describe this photo in one detailed sentence", "caption this image in one sentence",
             "describe a red car on a wet road")


def http_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.load(resp)


def check_spill_roundtrip(gen, n_pages: int, seed: int) -> dict:
    """A spill round trip at the pool shapes ``gen`` serves, on a pool of
    its own: export a row of ``n_pages`` random pages (one device-to-host
    copy), resume it into another slot through a disjoint page grant,
    export it from there, and require the two packed payloads to be
    byte-equal (the first one also equal to the source pages). Returns the
    payload size and the export and resume times (host clock, around a
    synchronize)."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import migration

    on_card = gen.device.type == "cuda"
    pages = 4 * n_pages + 1
    pool = gen.init_pool(8, pages=pages, page_size=16)
    g = torch.Generator(device=gen.device)
    g.manual_seed(seed)
    for layer in pool["caches"]:
        for name in ("k", "v"):
            layer[name].copy_(torch.randn(layer[name].shape, generator=g, device=gen.device))
    pool["seen"][3] = torch.rand(pool["seen"].shape[1], generator=g, device=gen.device) < 0.01
    pool["cur_tok"][3], pool["cur_len"][3], pool["n_gen"][3] = 1234, n_pages * 16 - 5, 40
    n_pad = 1 << (n_pages - 1).bit_length()
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(seed)).numpy() + 1
    src, dst = np.zeros(n_pad, np.int32), np.zeros(n_pad, np.int32)
    src[:n_pages], dst[:n_pages] = perm[:n_pages], perm[n_pages : 2 * n_pages]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def leaves(host):
        return [layer[name] for layer in host["pages"] for name in ("k", "v")] + [host["seen"]]

    sync()
    t0 = time.perf_counter()
    first = gen.export_row(pool, 3, src)
    t1 = time.perf_counter()
    gen.resume(pool, 5, first["pages"], dst, first["seen"], first["cur_tok"], first["cur_len"],
               first["n_gen"], 68, 0.7, 1.0, True, 1.0)
    sync()
    t2 = time.perf_counter()
    second = gen.export_row(pool, 5, dst)
    blob_a, _ = migration.pack_payload(leaves(first))
    blob_b, _ = migration.pack_payload(leaves(second))
    scalars = lambda h: (h["cur_tok"], h["cur_len"], h["n_gen"])  # noqa: E731
    if blob_a != blob_b or scalars(first) != scalars(second):
        raise AssertionError("spill round trip: the second export differs from the first")
    ids = torch.as_tensor(src[:n_pages], dtype=torch.long, device=gen.device)
    k0 = pool["caches"][0]["k"].index_select(0, ids).cpu()
    if not torch.equal(k0.view(torch.int16), torch.from_numpy(first["pages"][0]["k"][:n_pages].view(np.int16))):
        raise AssertionError("spill round trip: the export differs from the pool's pages")
    if not (pool["sampling"][5] and bool(pool["do_sample"][5])):
        raise AssertionError("spill round trip: the resumed row lost its sampling state")
    return dict(nbytes=len(blob_a), export_ms=(t1 - t0) * 1e3, resume_ms=(t2 - t1) * 1e3, n_pad=n_pad)


def drive_defaults(seed: int, card: str, root: Path, phase6: dict, device: str = "cuda:0",
                   alone_reruns: int = 6) -> dict:
    """Phase 7: phase 6's model directory behind one bf16 ``serve()`` with
    the JAX server's defaults (spill tier, result cache, breaker,
    quarantine) plus the metrics sidecar and a 64 MiB prefix cache, on a
    KV pool pinned small enough that 8 requests must preempt. Drives, over
    gRPC: (a) pressure: 6 of phase 6's greedy streams and 2 sampled ones;
    (b) prefix reuse: one photo, three questions, cold and then in two
    waves; (c) the result cache: one ``vlm_generate`` twice; (d) the
    sidecar's ``/metrics.json`` and ``/stats`` and ``Health``. Every check
    raises. Launch counts are zeroed before (a) and read after (b); (c)'s
    second answer must launch nothing. ``alone_reruns`` of the greedy
    streams are also rerun alone on the idle server."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    import torch
    from google.protobuf import empty_pb2

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    all_k = all_kernels()
    photos, prompt = phase6["photos"], phase6["prompt"]
    # Live positions of phase 6's prompt: its text tokens, with the image
    # token expanded to the vision tokens.
    from lumen_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig.from_hf(json.loads((phase6["model_dir"] / "config.json").read_text()))
    live = phase6["streams"][0]["input_tokens"] - 1 + cfg.vision.num_tokens
    per_row = -(-(live + 1) // 16)
    budgets = [96 + 8 * i for i in range(6)] + [128, 128]
    longest = -(-(live + max(budgets) + 1) // 16)
    # Room for two rows' prompts and half a third: the chunk lane admits
    # one prompt every two decode blocks and page gating admits a row only
    # onto free pages, so pressure comes from two or three admitted rows
    # outgrowing the pool (a row grows by 6-9 pages). One row alone fits.
    pin = max(2 * per_row + per_row // 2, longest + 2) + 1
    if on_card:
        torch.cuda.empty_cache()
    # A fresh process-wide result cache, as a new server process has: phase
    # 6's server answered (c)'s request in this process already.
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache

    reset_result_cache()
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_KV_PAGES=str(pin), LUMEN_VLM_PREFIX_BYTES=str(PHASE7_PREFIX_BYTES)):
        handle, channel, stub, load_s = boot_server(
            deployment_yaml(root / "defaults.yaml", root / "cache", "SmokeVLM", None), device, metrics_port=0)
    try:
        mgr = handle.services["vlm"].manager
        eng = mgr.engine
        mport = handle.metrics_server.port
        log(f"phase 7: server with the default serving path up in {load_s:.2f} s, kv {mgr.kv_layout()} "
            f"({live} live prompt positions = {per_row} pages a row; pool pinned at {pin}), spill budget "
            f"{eng._spill_budget >> 20} MiB, prefix budget {PHASE7_PREFIX_BYTES >> 20} MiB, sidecar port {mport}")
        if eng.prefix is None or eng._spill_budget <= 0:
            raise AssertionError("phase 7: the prefix cache or the spill tier is off")

        def drop_prefixes():
            """Empty the prefix cache with the engine idle, so the next
            request prefills cold."""
            while eng.load():
                time.sleep(0.01)
            with eng._cond:  # the idle loop waits on it
                eng.prefix.clear()

        def stream(photo: bytes, budget: int, extra: dict | None = None, messages: str = prompt) -> dict:
            return grpc_call(stub, "vlm_generate_stream", photo,
                             {"messages": messages, "max_new_tokens": budget, **(extra or {})})

        # -- (a) pressure: 6 greedy streams of phase 6 and 2 sampled ones --
        # Budgets past phase 6's: the chunk lane admits one prompt every two
        # turns, so rows must live long enough to meet in the pool.
        greedy = list(range(6))
        jobs = [(photos[i], budgets[i], None) for i in greedy]
        jobs += [(photos[i], budgets[i], {"do_sample": "true", "temperature": 0.7}) for i in (6, 7)]
        for k in all_k:
            k.launches = 0
        pre0, res0 = eng.preemptions, eng.spill_resumes
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            streams = list(pool.map(lambda job: stream(*job), jobs))
        wall = time.perf_counter() - t_start
        failed = [(i, r["code"]) for i, r in enumerate(streams) if r["code"]]
        if failed:
            raise AssertionError(f"phase 7 (a): streams failed under pressure with the spill tier on: {failed}")
        for i, r in enumerate(streams):
            if b"".join(r["deltas"]).decode() != r["body"]["text"]:
                raise AssertionError(f"phase 7 (a): stream {i}'s deltas do not join to its final text")
        preempted, resumed = eng.preemptions - pre0, eng.spill_resumes - res0
        if preempted <= 0 or resumed <= 0:
            raise AssertionError(f"phase 7 (a): {preempted} preemptions, {resumed} spill resumes: no pressure")
        # Greedy answers under pressure: equal to the same request alone on
        # this server (cold, no pressure), and, over phase 6's shorter
        # budget, to phase 6's answer (each id decodes to one word).
        for i in greedy:
            got = (streams[i]["body"]["text"], streams[i]["body"]["generated_tokens"])
            if i in greedy[:alone_reruns]:
                drop_prefixes()
                alone = stream(*jobs[i])
                if alone["code"] or (alone["body"]["text"], alone["body"]["generated_tokens"]) != got:
                    raise AssertionError(f"phase 7 (a): greedy stream {i} under pressure differs from it alone")
            ref = phase6["streams"][i]
            words, ref_words = got[0].split(), ref["text"].split()
            eos6 = ref["generated_tokens"] < phase6["budgets"][i]
            if words[: len(ref_words)] != ref_words or (eos6 and got[1] != ref["generated_tokens"]):
                raise AssertionError(f"phase 7 (a): greedy stream {i} differs from phase 6's unpressured answer")
        g = eng.gauges()
        path = ("shm arena" if g.get("spill_arena_segments") else "") + (
            f"{' and ' if g.get('spill_arena_segments') else ''}host arrays ({g['spill_fallbacks']} fallbacks)"
            if g["spill_fallbacks"] else "")
        tokens = sum(r["body"]["generated_tokens"] for r in streams)
        ttfts = [round(r["ttft_ms"], 2) for r in streams]
        log(f"phase 7 (a): 8 streams (6 greedy, 2 sampled at 0.7), {tokens} tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tok/s; {preempted} preemptions, {g['spilled']} spills, {resumed} resumes, "
            f"{g['preempt_redone']} redone, {g['preempt_failed']} shed; spill path: {path}; the 6 greedy "
            f"streams equal phase 6's unpressured answers over its budgets, {min(alone_reruns, len(greedy))} of them "
            f"themselves alone [{card}]")

        # -- (b) prefix reuse: one photo, three questions --------------------
        def ask(q: str) -> dict:
            r = stream(photos[8], 24, messages=json.dumps([{"role": "user", "content": q}]))
            if r["code"]:
                raise AssertionError(f"phase 7 (b): {q!r} failed with code {r['code']}")
            return r["body"]

        chunks0 = eng.chunks_run
        cold = []
        for q in QUESTIONS:
            drop_prefixes()
            cold.append(ask(q))
        cold_chunks = eng.chunks_run - chunks0
        drop_prefixes()
        hits0, chunks0 = eng.prefix_hits, eng.chunks_run
        wave1 = [ask(QUESTIONS[0])]
        with ThreadPoolExecutor(max_workers=2) as pool:
            wave2 = list(pool.map(ask, QUESTIONS[1:]))
        warm_chunks, hits = eng.chunks_run - chunks0, eng.prefix_hits - hits0
        launches = {k.name: k.launches for k in all_k}
        warm = wave1 + wave2
        if hits <= 0 or warm_chunks >= cold_chunks:
            raise AssertionError(f"phase 7 (b): {hits} prefix hits, {warm_chunks} chunks warm vs {cold_chunks} cold")
        if any("prefix_hit" not in b["metadata"] for b in warm) or not all(
                b["metadata"]["prefix_hit"] > 0 for b in wave2):
            raise AssertionError(f"phase 7 (b): prefix_hit metadata {[b['metadata'].get('prefix_hit') for b in warm]}")
        if [(b["text"], b["generated_tokens"]) for b in warm] != [(b["text"], b["generated_tokens"]) for b in cold]:
            raise AssertionError("phase 7 (b): prefix-hit answers differ from the cold answers")
        log(f"phase 7 (b): one photo, {len(QUESTIONS)} questions: cold {cold_chunks} prefill chunks; two waves "
            f"{warm_chunks} chunks, {hits} prefix hits (prefix_hit "
            f"{[b['metadata']['prefix_hit'] for b in warm]}), answers equal to the cold ones")
        missing = [n for n in PHASE4_KERNELS if launches[n] == 0]
        if missing:
            raise AssertionError(f"phase 7 never launched: {missing} (launches {launches})")
        log(f"phase 7: launches over (a) and (b) {json.dumps(launches)}")

        # -- (c) the result cache: one vlm_generate twice ---------------------
        meta = {"messages": prompt, "max_new_tokens": 16}
        first = grpc_call(stub, "vlm_generate", photos[10], meta)
        for k in all_k:
            k.launches = 0
        second = grpc_call(stub, "vlm_generate", photos[10], meta)
        again = {k.name: k.launches for k in all_k}
        if first["code"] or second["code"] or "cached" in first["body"]["metadata"]:
            raise AssertionError(f"phase 7 (c): codes {first['code']}/{second['code']}")
        if second["body"]["metadata"].get("cached") is not True or any(again.values()):
            raise AssertionError(f"phase 7 (c): second answer not from the result cache (launches {again})")
        if (second["body"]["text"], first["body"]["text"]) != (first["body"]["text"], phase6["unary"]["text"]):
            raise AssertionError("phase 7 (c): the cached answer differs from the computed one or phase 6's")
        log(f"phase 7 (c): vlm_generate computed in {first['s'] * 1e3:.1f} ms, answered again from the result "
            f"cache in {second['s'] * 1e3:.2f} ms with no kernel launch (client side, over gRPC) [{card}]")

        # -- (d) operations: the sidecar and Health ----------------------------
        snap = http_json(mport, "/metrics.json")
        stats = http_json(mport, "/stats?window=900")
        need = {"vlm_paged_preemptions", "vlm_spills", "vlm_spill_resumes", "vlm_prefix_hits", "vlm_prefix_misses"}
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {}).get("vlm-continuous:SmokeVLM", {})
        if not need <= set(counters) or not gauges or "vlm.ttft" not in snap["tasks"]:
            raise AssertionError(f"phase 7 (d): /metrics.json lacks {sorted(need - set(counters))}, "
                                 f"gauges {bool(gauges)}, vlm.ttft {'vlm.ttft' in snap['tasks']}")
        _, call = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        trailing = dict(call.trailing_metadata())
        if json.loads(trailing.get("lumen-breaker-status", "{}")) != {"vlm": "closed"}:
            raise AssertionError(f"phase 7 (d): Health trailer {trailing}")
        ttft = stats["tasks"]["vlm.ttft"]
        server = sorted(r["body"]["metadata"]["ttft_ms"] for r in streams)
        pct = lambda q: server[min(len(server) - 1, int(q * len(server)))]  # noqa: E731
        log(f"phase 7 (d): /metrics.json: {len([c for c in counters if c.startswith('vlm_')])} vlm_* counters "
            f"({', '.join(f'{c} {counters[c]}' for c in sorted(need))}), {len(gauges)} vlm-continuous:SmokeVLM "
            f"gauges; Health trailer lumen-breaker-status {trailing['lumen-breaker-status']}, "
            f"lumen-quarantine-size {trailing.get('lumen-quarantine-size')}")
        log(f"phase 7 (d): TTFT of (a)'s 8 streams, server p50 {pct(0.5):.1f} ms p95 {pct(0.95):.1f} ms (the "
            f"vlm.ttft observations, exact), client {sorted(ttfts)}; the sidecar's vlm.ttft histogram (every "
            f"stream of this process, phases 6-7: {ttft['count']}) p50 {ttft['p50_ms']} ms p95 "
            f"{ttft['p95_ms']} ms (bucket bounds) [{card}]")

        # -- spill round trip at the full-width pool shapes ---------------------
        rt = check_spill_roundtrip(eng.gen, per_row + 5, seed + 7)
        log(f"phase 7: spill round trip of a {per_row + 5}-page row (padded to {rt['n_pad']}): export, resume "
            f"into another grant, export again: payloads byte-equal ({rt['nbytes']} B); export "
            f"{rt['export_ms']:.2f} ms, resume {rt['resume_ms']:.2f} ms (host clock) [{card}]")
        while eng.load():
            time.sleep(0.01)
        stats_kv = eng.kv.stats()
        if stats_kv.pages_live != len(set(eng.prefix.held_pages())) or eng._spill_ledger:
            raise AssertionError(f"phase 7: pages or spill records left after drain: {stats_kv}, "
                                 f"{len(eng._spill_ledger)} spill records")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    return dict(load_s=load_s, launches=launches, preempted=preempted, resumed=resumed, prefix_hits=hits,
                wall_s=wall, tokens=tokens, cached_ms=second["s"] * 1e3, phase_s=time.perf_counter() - t_phase)


# -- phase 8: CLIP embeddings and zero-shot labels over gRPC --------------------

#: phase 8's tolerance: the cosine between an embedding the server answers
#: (bf16, the flash kernel in every tower block) and the same input through
#: a direct ``CLIPModel`` on the card with the plain attention (same
#: weights, same decoded pixels or token ids), and between photo 0 alone
#: and inside a full batch.
CLIP_COSINE = 0.999
#: the kernels phase 8 must launch: both CLIP towers' unmasked attention
PHASE8_KERNELS = ("flash_attention",)
#: the flash kernel's CLIP calls at the bulk batch of 64 (phase 2):
#: ViT-B/32 vision tower q/k/v [64, 12, 50, 64], causal text tower [64, 8, 77, 64]
CLIP_FLASH_SHAPES = {"CLIP vision": (64, 12, 50, False), "CLIP text, causal": (64, 8, 77, True)}
#: words of the phase-8 vocabulary besides its label and filler tokens
CLIP_WORDS = ("a", "photo", "of", "person", "animal", "vehicle", "food", "building", "nature", "an",
              "object", "landscape", "cat", "dog", "red", "car", "on", "wet", "road", "in", "the", "snow")

#: port ``state_dict`` name -> HF ``CLIPModel`` name (the inverse of the
#: HF rules ``models/clip/convert.py`` reads)
_CLIP_HF_NAMES = (
    (r"vision\.patch_embed\.weight", "vision_model.embeddings.patch_embedding.weight"),
    (r"vision\.class_embedding", "vision_model.embeddings.class_embedding"),
    (r"vision\.position_embedding", "vision_model.embeddings.position_embedding.weight"),
    (r"vision\.pre_ln\.(weight|bias)", r"vision_model.pre_layrnorm.\1"),
    (r"vision\.post_ln\.(weight|bias)", r"vision_model.post_layernorm.\1"),
    (r"vision\.projection\.weight", "visual_projection.weight"),
    (r"text\.token_embedding\.weight", "text_model.embeddings.token_embedding.weight"),
    (r"text\.position_embedding", "text_model.embeddings.position_embedding.weight"),
    (r"text\.final_ln\.(weight|bias)", r"text_model.final_layer_norm.\1"),
    (r"text\.projection\.weight", "text_projection.weight"),
    (r"(vision|text)\.blocks\.(\d+)\.attn\.(\w+)\.(weight|bias)", r"\1_model.encoder.layers.\2.self_attn.\3.\4"),
    (r"(vision|text)\.blocks\.(\d+)\.ln([12])\.(weight|bias)", r"\1_model.encoder.layers.\2.layer_norm\3.\4"),
    (r"(vision|text)\.blocks\.(\d+)\.mlp\.(fc[12])\.(weight|bias)", r"\1_model.encoder.layers.\2.mlp.\3.\4"),
    (r"logit_scale", "logit_scale"),
)


def clip_hf_state(state) -> dict:
    """A port CLIP ``state_dict`` under the HF ``CLIPModel`` names; the
    patch embedding goes back to an OIHW conv weight."""
    out = {}
    for key, t in state.items():
        for pat, template in _CLIP_HF_NAMES:
            if m := re.fullmatch(pat, key):
                break
        else:
            raise KeyError(f"no HF name for {key!r}")
        if key == "vision.patch_embed.weight":  # [W, P*P*C] (row, column, channel) -> OIHW
            width, n = t.shape
            p = int(round((n // 3) ** 0.5))
            t = t.reshape(width, p, p, 3).permute(0, 3, 1, 2)
        out[m.expand(template)] = t.contiguous()
    return out


def clip_hf_config(cfg) -> dict:
    """``config.json`` that ``CLIPConfig.from_hf`` reads back as ``cfg``."""
    v, t = cfg.vision, cfg.text
    return {
        "model_type": "clip", "projection_dim": cfg.embed_dim,
        "vision_config": {
            "hidden_size": v.width, "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
            "intermediate_size": 4 * v.width, "image_size": cfg.image_size, "patch_size": cfg.patch_size,
            "hidden_act": cfg.hidden_act, "layer_norm_eps": cfg.layer_norm_eps,
        },
        "text_config": {
            "hidden_size": t.width, "num_hidden_layers": t.layers, "num_attention_heads": t.heads,
            "intermediate_size": 4 * t.width, "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.context_length, "eos_token_id": cfg.eot_token_id,
            "hidden_act": cfg.hidden_act,
        },
    }


def clip_label(i: int) -> str:
    return f"c{i}"


def write_clip_tokenizer(path: Path, cfg, n_labels: int) -> None:
    """A ``tokenizers`` WordLevel vocabulary of all ``vocab_size`` ids:
    ``<|startoftext|>`` and ``<|endoftext|>`` (the EOT id, ``vocab_size - 1``)
    at the top as in OpenAI CLIP's, ``CLIP_WORDS`` and the dataset's label
    words below, ``w<id>`` for the rest; every text is wrapped in the two."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers
    from tokenizers.processors import TemplateProcessing

    bos, eot = cfg.vocab_size - 2, cfg.eot_token_id
    names = {0: "<unk>", bos: "<|startoftext|>", eot: "<|endoftext|>"}
    for k, word in enumerate(CLIP_WORDS + tuple(clip_label(i) for i in range(n_labels))):
        names[1 + k] = word
    vocab = {names.get(i, f"w{i}"): i for i in range(cfg.vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(names[bos], special=True), AddedToken(names[eot], special=True)])
    tok.post_processor = TemplateProcessing(
        single=f"{names[bos]} $A {names[eot]}", special_tokens=[(names[bos], bos), (names[eot], eot)])
    tok.save(str(path))


def write_clip_model_dir(root: Path, name: str, cfg, state, n_labels: int) -> Path:
    """A CLIP model directory as the loader reads one: ``model.safetensors``
    under the HF names, ``config.json``, ``tokenizer.json`` and
    ``model_info.json`` with a dataset of ``n_labels`` labels and no
    ``.npy``, so the server embeds the labels at start-up."""
    from safetensors.torch import save_file

    model_dir = root / "models" / name
    (model_dir / "datasets" / "smoke").mkdir(parents=True)
    save_file({k: v.cpu() for k, v in clip_hf_state(state).items()}, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps(clip_hf_config(cfg)))
    write_clip_tokenizer(model_dir / "tokenizer.json", cfg, n_labels)
    (model_dir / "datasets" / "smoke" / "labels.json").write_text(
        json.dumps([clip_label(i) for i in range(n_labels)]))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "seeded random weights for chip_smoke.py",
        "model_type": "clip", "embedding_dim": cfg.embed_dim,
        "source": {"format": "huggingface", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors"]}},
        "datasets": {"Smoke1k": {"labels": "datasets/smoke/labels.json",
                                 "embeddings": "datasets/smoke/embeddings.npy"}},
    }))
    return model_dir


def hub_yaml(path: Path, cache_dir: Path, clip_model: str, batch_size: int, vlm_model: str | None = None) -> Path:
    """A hub deployment: ``clip`` (bf16, the bulk batch, warm-up on), and
    ``vlm`` beside it when ``vlm_model`` names one; services named in their
    JAX form."""
    import yaml

    services = {"clip": {
        "enabled": True, "package": "lumen_tpu.models.clip",
        "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
        "backend_settings": {"dtype": "bfloat16", "batch_size": batch_size, "warmup": True},
        "models": {"clip": {"model": clip_model, "runtime": "jax", "dataset": "Smoke1k"}},
    }}
    if vlm_model:
        services["vlm"] = {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": {"dtype": "bfloat16", "batch_size": 8},
            "models": {"vlm": {"model": vlm_model, "runtime": "jax"}},
        }
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": sorted(services)},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": services,
    }))
    return path


@contextlib.contextmanager
def plain_attention(modeling=None):
    """Run a family's attention (the CLIP towers' unless ``modeling`` names
    another family's modeling module) through the plain version (on any
    device) while inside: the reference the kernel's answers are held to."""
    from lumen_tpu_torch.ops.attention import attention_reference

    if modeling is None:
        from lumen_tpu_torch.models.clip import modeling
    kernel = modeling.attention
    modeling.attention = lambda q, k, v, mask=None, causal=False, scale=None: attention_reference(
        q, k, v, mask=mask, causal=causal, scale=scale)
    try:
        yield
    finally:
        modeling.attention = kernel


def photo_batch(seed: int, n: int, width: int = 1600, height: int = 1200) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs (one gradient, a per-photo
    tint and a per-photo shift of one noise field), encoded in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)
    noise = rng.normal(0, 12, (height, width, 3)).astype(np.float32)
    tints = rng.uniform(60, 220, (n, 3)).astype(np.float32)
    shifts = rng.integers(0, width, n)

    def one(i: int) -> bytes:
        img = np.clip(base * tints[i] + np.roll(noise, int(shifts[i]), axis=1), 0, 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        return buf.tobytes()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def cosines(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def drive_clip(seed: int, card: str, root: Path, phase6: dict, cfg=None, device: str = "cuda:0",
               n_photos: int = 128, in_flight: int = 64, batch_size: int = 64, n_labels: int = 1000) -> dict:
    """Phase 8: a full-width CLIP model directory (``CLIPConfig()``, the
    OpenAI ViT-B/32 shapes) served by ``serve()`` over real gRPC, then a
    hub of ``clip`` + ``vlm`` (phase 6's directory under ``root``).
    ``cfg``/``device`` and the counts let the CPU tests rehearse it small;
    the launch-count gate (``PHASE8_KERNELS``) then fails unless emptied."""
    import dataclasses
    import math
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.models.clip import SCENE_LABELS, CLIPConfig, CLIPModel, convert_clip_checkpoint
    from lumen_tpu_torch.models.vlm.modeling import init_random_
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    cfg = cfg or dataclasses.replace(CLIPConfig(), eot_token_id=CLIPConfig().vocab_size - 1)
    on_card = torch.device(device).type == "cuda"
    if CLIPConfig.from_hf(clip_hf_config(cfg)) != cfg:
        raise AssertionError("config.json does not read back as the served CLIP configuration")
    with torch.device(device):
        model = CLIPModel(cfg)
    init_random_(model, seed + 8)
    with torch.no_grad():
        model.logit_scale.fill_(math.log(1 / 0.07))
    state = model.to(torch.bfloat16).state_dict()
    del model
    model_dir = write_clip_model_dir(root / "cache", "SmokeCLIP", cfg, state, n_labels)
    if any(not torch.equal(v.cpu(), state[k].cpu()) for k, v in
           convert_clip_checkpoint({k: v.cpu() for k, v in clip_hf_state(state).items()}).items()):
        raise AssertionError("the HF-named checkpoint does not convert back to the seeded weights")
    mb = sum(f.stat().st_size for f in model_dir.rglob("*") if f.is_file()) / 2**20
    photos = photo_batch(seed * 100 + 8, n_photos + 12 + 16)
    extra, warm, photos = photos[n_photos:n_photos + 12], photos[n_photos + 12:], photos[:n_photos]
    v, t = cfg.vision, cfg.text
    log(f"phase 8: model directory of a CLIPConfig (vision {v.width}/{v.layers}/{v.heads} patch {cfg.patch_size} at "
        f"{cfg.image_size} px, text {t.width}/{t.layers}/{t.heads} at {cfg.context_length} tokens, seeded bf16 "
        f"weights, HF names, {cfg.vocab_size}-id tokenizer, {n_labels} labels, no .npy) written, {mb:.0f} MiB; "
        f"{n_photos + 28} distinct 1600x1200 JPEGs")
    size = cfg.image_size
    # The direct model: the seeded weights on the card, the plain attention.
    with torch.device(device):
        direct = CLIPModel(cfg)
    direct.load_state_dict(state, strict=True)
    direct = direct.to(torch.bfloat16).eval().requires_grad_(False)
    all_k = all_kernels()
    flash = next(k for k in all_k if k.name == "flash_attention")
    out: dict = {}

    reset_result_cache()  # a fresh process-wide result cache, as a new server process has
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if on_card else 0  # the direct model and the seeded state
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            hub_yaml(root / "clip.yaml", root / "cache", "SmokeCLIP", batch_size), device)
    try:
        svc = handle.services["clip"]
        mgr = svc.managers["clip"]
        ib, tb = mgr._image_batcher, mgr._text_batcher
        pool = get_decode_pool()
        log(f"phase 8: clip server up in {load_s:.2f} s (serve() to the first Health ok, {len(mgr._fleet_models)} "
            f"replica(s), buckets {ib.buckets} warmed), label embeddings of {len(mgr.label_names)} labels at "
            f"start-up in {mgr.label_embed_s * 1e3:.1f} ms through the causal text tower; decode pool "
            f"{'process' if pool.process_mode else 'thread'} mode, {pool.procs} worker processes, "
            f"{pool.workers} threads [{card}]")

        def encode_plain(pixels=None, ids=None):
            with plain_attention():
                if pixels is not None:
                    return mgr._encode_images(direct, torch.from_numpy(np.stack(pixels)).to(device)).cpu().numpy()
                return mgr._encode_texts(direct, torch.from_numpy(ids).to(device)).cpu().numpy()

        def expect_unit(vec, what):
            vec = np.asarray(vec, np.float64)
            if vec.shape != (cfg.embed_dim,) or not np.isfinite(vec).all() or abs(np.linalg.norm(vec) - 1) > 1e-3:
                raise AssertionError(f"{what}: embedding of shape {vec.shape}, norm {np.linalg.norm(vec):.5f}")
            return vec

        # The first photos start the decode pool's workers (spawned at first
        # use) and the fetch path's side stream and pinned buffers: a cold
        # round of 16, timed apart from (a).
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as ex:
            cold = list(ex.map(lambda p: grpc_call(stub, "clip_image_embed", p, {}), warm))
        cold_s = time.perf_counter() - t0
        if any(r["code"] for r in cold):
            raise AssertionError(f"phase 8: the cold round answered codes {[r['code'] for r in cold]}")
        log(f"phase 8: cold round (decode workers starting): 16 photos, 16 in flight, in {cold_s:.3f} s")

        # -- (a) 128 photos over gRPC, 64 in flight ---------------------------
        before = dict(ib.stats)
        flash.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            embeds = list(ex.map(lambda p: grpc_call(stub, "clip_image_embed", p, {}), photos))
        wall = time.perf_counter() - t0
        vision_launches = flash.launches
        batches = ib.stats["batches"] - before["batches"]
        items = ib.stats["items"] - before["items"]
        if any(r["code"] for r in embeds):
            raise AssertionError(f"phase 8 (a): codes {sorted({r['code'] for r in embeds})}")
        vecs = np.stack([expect_unit(r["body"]["vector"], f"photo {i}") for i, r in enumerate(embeds)])
        pixels = [_spec_clip_resize(p, {"size": size}) for p in photos]
        plain = np.concatenate([encode_plain(pixels[i:i + batch_size]) for i in range(0, n_photos, batch_size)])
        cos_a = cosines(vecs, plain)
        if cos_a.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (a): cosine to the plain path {cos_a.min():.6f} < {CLIP_COSINE}")
        if on_card:
            # The path ran pinned staging and the side-stream fetch.
            staged = [b for ring in ib._arenas.values() for bufs in ring for b in bufs]
            if not staged or not all(isinstance(b, torch.Tensor) and b.is_pinned() for b in staged) \
                    or not ib._d2h_streams:
                raise AssertionError("phase 8 (a): the image batcher staged without pinned memory or fetched "
                                     "without its side stream")
            batch = torch.from_numpy(np.stack(pixels[:batch_size])).to(device)
            batch_ms = cuda_ms(lambda: mgr._encode_images(mgr.model, batch), 10)
        else:
            batch_ms = float("nan")
        lat = sorted(r["s"] * 1e3 for r in embeds)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        fill = items / max(batches * ib.buckets[-1], 1)
        log(f"phase 8 (a): {n_photos} clip_image_embed over gRPC ({in_flight} in flight) in {wall:.3f} s = "
            f"{n_photos / wall:.1f} images/s; client latency p50 {pct(0.5):.1f} ms p95 {pct(0.95):.1f} ms; "
            f"{batches} image batches, mean fill {100 * fill:.1f}% of {ib.buckets[-1]}; cosine to a direct "
            f"CLIPModel with the plain attention (same weights, same pixels) min {cos_a.min():.6f} "
            f"(tol {CLIP_COSINE}); one batch of {batch_size} through the vision tower {batch_ms:.3f} ms on the "
            f"device (CUDA events, launch path included: {batch_size / batch_ms * 1e3:.0f} images/s) [{card}]")

        # -- (b) 32 texts -----------------------------------------------------
        texts = [f"a photo of a {CLIP_WORDS[3 + i % 19]} in the {CLIP_WORDS[12 + i % 10]} {clip_label(i)}"
                 for i in range(32)]
        before_t = dict(tb.stats)
        flash.launches = 0
        with ThreadPoolExecutor(16) as ex:
            tembeds = list(ex.map(lambda t: grpc_call(stub, "clip_text_embed", t.encode(), {}, mime="text/plain"),
                                  texts))
        text_launches = flash.launches
        text_batches = tb.stats["batches"] - before_t["batches"]
        if any(r["code"] for r in tembeds):
            raise AssertionError(f"phase 8 (b): codes {sorted({r['code'] for r in tembeds})}")
        tvecs = np.stack([expect_unit(r["body"]["vector"], f"text {i}") for i, r in enumerate(tembeds)])
        cos_b = cosines(tvecs, encode_plain(ids=mgr.tokenizer.encode_batch(texts)))
        if cos_b.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (b): cosine to the plain path {cos_b.min():.6f} < {CLIP_COSINE}")
        log(f"phase 8 (b): 32 clip_text_embed in {text_batches} text batches; cosine to the plain path min "
            f"{cos_b.min():.6f}")

        # -- (c) 8 classify (top 5), 4 scene ------------------------------------
        flash.launches = 0
        before_c = dict(ib.stats)
        with ThreadPoolExecutor(12) as ex:
            labels = list(ex.map(lambda i: grpc_call(
                stub, "clip_classify" if i < 8 else "clip_scene_classify", extra[i], {"top_k": 5} if i < 8 else {}),
                range(12)))
        classify_launches = flash.launches
        if any(r["code"] for r in labels):
            raise AssertionError(f"phase 8 (c): codes {[r['code'] for r in labels]}")
        served = [np.asarray(grpc_call(stub, "clip_image_embed", p, {})["body"]["vector"]) for p in extra]
        plain_c = encode_plain([_spec_clip_resize(p, {"size": size}) for p in extra])
        exact = 0
        for i, r in enumerate(labels):
            got = [(x["label"], x["score"]) for x in r["body"]["labels"]]
            matrix, names, temp = ((mgr._label_matrix, mgr.label_names, mgr.temperature()) if i < 8
                                   else (mgr._scene_matrix, SCENE_LABELS, 1.0))
            if len(got) != (5 if i < 8 else 3):
                raise AssertionError(f"phase 8 (c): request {i} answered {len(got)} labels")
            # The served labels are the served embedding's softmax top-k.
            sims = matrix @ served[i].astype(np.float32)
            probs = np.exp(sims * temp - (sims * temp).max())
            probs /= probs.sum()
            order = np.argsort(-probs)[:len(got)]
            if [names[j] for j in order] != [g[0] for g in got] or not np.allclose(
                    probs[order], [g[1] for g in got], atol=1e-5):
                raise AssertionError(f"phase 8 (c): request {i}'s labels are not its embedding's top-k")
            # Top-1 against the plain path: equal, unless the plain path's
            # own top two lie within 2 * |served - plain| (the most the
            # embeddings' difference can move a cosine score).
            plain_sims = matrix @ plain_c[i]
            top = np.argsort(-plain_sims)[:2]
            delta = float(np.linalg.norm(served[i] - plain_c[i]))
            if names[top[0]] == got[0][0]:
                exact += 1
            elif plain_sims[top[0]] - plain_sims[top[1]] > 2 * delta or \
                    plain_sims[names.index(got[0][0])] < plain_sims[top[0]] - 2 * delta:
                raise AssertionError(f"phase 8 (c): request {i}'s top-1 {got[0][0]} vs the plain path's "
                                     f"{names[top[0]]}, margin {plain_sims[top[0]] - plain_sims[top[1]]:.5f}, "
                                     f"2|delta| {2 * delta:.5f}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"phase 8 (c): 8 clip_classify (top 5 of {len(mgr.label_names)}) and 4 clip_scene_classify answered; "
            f"labels are each embedding's softmax top-k; top-1 equal to the plain path's in {exact} of 12 (the "
            f"others tie within 2|served - plain|)")
        launches = {"vision (a)": vision_launches, "text (b)": text_launches, "classify (c)": classify_launches}
        layers_v, layers_t = cfg.vision.layers, cfg.text.layers
        need = {"vision (a)": layers_v * batches, "text (b)": layers_t * text_batches}
        for name in PHASE8_KERNELS:
            short = [k for k, n in need.items() if launches[k] < n or n == 0]
            if short:
                raise AssertionError(f"phase 8: {name} never launched enough in {short}: launches {launches}, "
                                     f"needed {need} ({layers_v}/{layers_t} layers x batches)")
        log(f"phase 8: flash_attention launches {json.dumps(launches)} (>= layers x batches: {json.dumps(need)}); "
            f"classify batches {ib.stats['batches'] - before_c['batches']}")

        # -- (d) photo 0 again, and as tensor/raw --------------------------------
        flash.launches = 0
        items0 = ib.stats["items"]
        again = grpc_call(stub, "clip_image_embed", photos[0], {})
        if again["code"] or again["meta"].get("cache_hit") != "1" or flash.launches or ib.stats["items"] != items0:
            raise AssertionError(f"phase 8 (d): the repeat was not a cached answer (meta {again['meta']}, "
                                 f"launches {flash.launches})")
        if again["body"]["vector"] != embeds[0]["body"]["vector"]:
            raise AssertionError("phase 8 (d): the cached answer differs from the computed one")
        payload, tmeta = tensor_payload(pixels[0])
        alone = grpc_call(stub, "clip_image_embed", payload, tmeta, mime=TENSOR_MIME)
        if alone["code"]:
            raise AssertionError(f"phase 8 (d): tensor/raw answered code {alone['code']}")
        cos_d = float(cosines(expect_unit(alone["body"]["vector"], "tensor/raw"), vecs[0]))
        if cos_d < CLIP_COSINE:
            raise AssertionError(f"phase 8 (d): photo 0 alone vs in a full batch, cosine {cos_d:.6f}")
        log(f"phase 8 (d): photo 0 again answered from the result cache in {again['s'] * 1e3:.2f} ms with no "
            f"launch; photo 0 as tensor/raw ({size}x{size}x3 uint8) alone vs in a batch of "
            f"{ib.buckets[-1]}: cosine {cos_d:.6f}")

        # -- (e) a malformed image ---------------------------------------------------
        bad = grpc_call(stub, "clip_image_embed", b"\xff\xd8 not a jpeg", {})
        if bad["code"] != pb.ERROR_CODE_INVALID_ARGUMENT:
            raise AssertionError(f"phase 8 (e): a malformed image answered code {bad['code']}")
        caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        if caps.runtime != ("torch-cuda" if on_card else "torch-cpu") or {t.name for t in caps.tasks} != {
                "clip_image_embed", "clip_text_embed", "clip_classify", "clip_scene_classify"}:
            raise AssertionError(f"phase 8: capabilities {caps.runtime} {[t.name for t in caps.tasks]}")
        decode_ms = []
        for _ in range(5):
            t = time.perf_counter()
            _spec_clip_resize(photos[0], {"size": size})
            decode_ms.append((time.perf_counter() - t) * 1e3)
        log(f"phase 8 (e): malformed image INVALID_ARGUMENT; decode of one 1600x1200 JPEG to {size}x{size} "
            f"{sorted(decode_ms)[2]:.2f} ms (median of 5, scaled decode + resize, one thread), pool queue wait "
            f"p50 {pool.wait_ms_p50():.2f} ms; peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
            f"held before the server booted: the direct model and the seeded state) [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    out.update(load_s=load_s, images_s=n_photos / wall, p50_ms=pct(0.5), p95_ms=pct(0.95), fill=fill, cold_s=cold_s,
               batch_ms=batch_ms,
               decode_ms=sorted(decode_ms)[2], peak_gib=peak / 2**30, label_s=mgr.label_embed_s,
               launches=launches, cos_min=float(min(cos_a.min(), cos_b.min(), cos_d)),
               # what phase 9 holds the exported towers and its hub to
               cfg=cfg, state=state, photos=photos[:16], vecs=vecs[:16], texts=texts[:8], tvecs=tvecs[:8],
               label_matrix=np.array(mgr._label_matrix))

    # -- (f) a hub of clip + vlm: 4 caption streams while 32 photos embed -----------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(
            hub_yaml(root / "hub.yaml", root / "cache", "SmokeCLIP", batch_size, vlm_model="SmokeVLM"), device)
    try:
        caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        tasks = {t.name for t in caps.tasks}
        if not {"clip_image_embed", "vlm_generate_stream"} <= tasks:
            raise AssertionError(f"phase 8 (f): the hub serves {sorted(tasks)}")
        n_vlm, n_img = 4, min(32, n_photos)

        def job(i):
            if i < n_vlm:
                return grpc_call(stub, "vlm_generate_stream", phase6["photos"][i],
                                 {"messages": phase6["prompt"], "max_new_tokens": phase6["budgets"][i]})
            return grpc_call(stub, "clip_image_embed", photos[i - n_vlm], {})

        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_vlm + n_img) as ex:
            res = list(ex.map(job, range(n_vlm + n_img)))
        hub_wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 8 (f): codes {[r['code'] for r in res]}")
        for i in range(n_vlm):
            want = phase6["streams"][i]
            if (res[i]["body"]["text"], res[i]["body"]["generated_tokens"]) != (want["text"], want["generated_tokens"]):
                raise AssertionError(f"phase 8 (f): caption stream {i} in the hub differs from phase 6's")
        cos_f = cosines(np.stack([r["body"]["vector"] for r in res[n_vlm:]]), vecs[:n_img])
        if cos_f.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (f): hub embeddings vs (a)'s, cosine {cos_f.min():.6f}")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    live = [t.name for t in threading.enumerate()
            if t.name.startswith(("clip-image", "clip-text", "vlm-continuous"))]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 8 (f): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 8 (f): hub of clip + vlm up in {hub_s:.2f} s; 4 vlm_generate_stream beside 32 clip_image_embed "
        f"in {hub_wall:.3f} s: captions equal to phase 6's, embeddings cosine min {cos_f.min():.6f} to (a)'s; "
        f"stop retired {len([t for t in threads if t.startswith(('clip-', 'vlm-continuous'))])} batcher/engine "
        f"threads and the decode pool's {len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, phase_s=time.perf_counter() - t_phase)
    return out


#: phase 9's bounds: a served detection matches its reference at IoU >=
#: FACE_IOU, one to one; a served embedding has cosine >= FACE_COSINE to
#: the reference's
FACE_IOU, FACE_COSINE = 0.99, 0.999
#: the share of anchors a calibration photo puts above the pack's score
#: threshold once the stand-ins' score heads are calibrated, and the spread
#: of their logits (as sparse and as separated as a trained detector's;
#: seeded random heads score every anchor near 0.5)
FACE_TOP_SHARE, FACE_LOGIT_STD = 0.002, 2.0
#: the kernels phase 9's hub must launch (the native CLIP towers; the face
#: path and the bridge run no hand-written kernel)
PHASE9_KERNELS = ("flash_attention",)
#: how far a candidate's score may move when the convolutions run in TF32
#: (10 mantissa bits, relative rounding 2**-11 a product), as users run
#: them, against the IEEE float32 reference: 3x the largest difference
#: measured on a batch of 16 (6.55e-4, NVIDIA H100 80GB HBM3, 700.00 W)
TF32_SCORE_TOL = 2e-3


def face_photos(seed: int, n: int, width: int = 1280, height: int = 1280) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs: a tinted gradient, noise and
    three to five bright discs each."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)
    out = []
    for _ in range(n):
        img = base * rng.uniform(40, 160, 3) + rng.normal(0, 10, (height, width, 3))
        for _ in range(int(rng.integers(3, 6))):
            cx, cy, r = int(rng.integers(0, width)), int(rng.integers(0, height)), int(rng.integers(30, 120))
            cv2.circle(img, (cx, cy), r, tuple(float(v) for v in rng.uniform(200, 255, 3)), -1)
        ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        out.append(buf.tobytes())
    return out


def calibrate_score_heads(model, convs, nhwc: bool, seed: int, logit_threshold: float) -> None:
    """Scale and shift the score convolutions so that their logits spread
    with standard deviation ``FACE_LOGIT_STD`` over the anchors of a
    seeded photo and ``FACE_TOP_SHARE`` of them score above the threshold.
    Seeded heads put every logit in a narrow band near 0: every anchor
    passes a 0.4 threshold, and the candidates at the top-k cut and the
    threshold lie a few ulps apart, where any two correct float32
    computations may order them differently. (The photos are square, as
    the calibration's: the seeded nets answer the letterbox's flat fill
    far outside their answers to photos, and a pad would outscore them.)"""
    import torch

    photo = torch.from_numpy(face_pixels(face_photos(seed, 1)[0])[0])[None].float()

    def logits_of(pixels):
        out = []
        hooks = [c.register_forward_hook(lambda m, i, o: out.append(o.detach().flatten())) for c in convs]
        try:
            x = (pixels - 127.5) / 128.0
            with torch.no_grad():
                model(x if nhwc else x.permute(0, 3, 1, 2))
        finally:
            for h in hooks:
                h.remove()
        return torch.cat(out).double()

    z = logits_of(photo)
    a = FACE_LOGIT_STD / float(z.std())
    q = float(torch.quantile(z * a, 1 - FACE_TOP_SHARE))
    with torch.no_grad():
        for c in convs:
            c.weight.mul_(a)
            c.bias.mul_(a).add_(logit_threshold - q)


def write_face_pack(root: Path, seed: int, det_width: int, rec_layers, rec_width: int):
    """The ``buffalo_l`` stand-in pack (``lumen_tpu_torch/testing/face_standins.py``):
    ``det_10g.onnx`` (640x640, the 9-output contract) and ``w600k_r50.onnx``
    (112x112 -> 512) exported on the CPU from seeded weights and BN
    statistics, score heads calibrated; returns the directory and the two
    modules (float32, CPU, eval)."""
    import torch

    from lumen_tpu_torch.testing.face_standins import iresnet_insightface, randomize_bn_stats, scrfd_det10g
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    torch.manual_seed(seed)
    det, rec = scrfd_det10g(det_width), iresnet_insightface(rec_layers, rec_width)
    randomize_bn_stats(det, seed + 1)
    randomize_bn_stats(rec, seed + 2)
    det.eval()
    rec.eval()
    calibrate_score_heads(det, [h.score for h in det.heads], False, seed + 3, math.log(0.4 / 0.6))
    model_dir = root / "models" / "buffalo_l"
    model_dir.mkdir(parents=True)
    export_onnx(det, (torch.zeros(1, 3, 640, 640),), str(model_dir / "det_10g.onnx"), input_names=["input"],
                dynamic_axes={"input": {0: "b"}})
    export_onnx(rec, (torch.zeros(1, 3, 112, 112),), str(model_dir / "w600k_r50.onnx"), input_names=["input"],
                dynamic_axes={"input": {0: "b"}})
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": "buffalo_l", "version": "1.0.0", "description": "seeded stand-ins of the InsightFace pack",
        "model_type": "face", "embedding_dim": 512,
        "source": {"format": "custom", "repo_id": "LumilioPhotos/buffalo_l"},
        "runtimes": {"onnx": {"available": True, "files": ["det_10g.onnx", "w600k_r50.onnx"]}},
    }))
    return model_dir, det, rec


def write_native_face_dir(root: Path, seed: int, det_cfg, rec_cfg) -> Path:
    """A native face directory: ``DetectorConfig`` / ``IResNetConfig``
    modules with seeded weights and BN statistics (the detector's score
    head calibrated), written as the JAX package's native safetensors."""
    import torch
    from safetensors.torch import save_file

    from lumen_tpu_torch.models.face import FaceDetector, IResNet
    from lumen_tpu_torch.testing.face_standins import native_face_checkpoint, randomize_bn_stats

    torch.manual_seed(seed)
    det, rec = FaceDetector(det_cfg).eval(), IResNet(rec_cfg).eval()
    randomize_bn_stats(det, seed + 1)
    randomize_bn_stats(rec, seed + 2)
    with torch.no_grad():
        # positive box distances (2 strides a side), as a trained head
        # regresses them; seeded ones straddle 0 and most boxes collapse
        det.head.reg.bias.fill_(2.0)
    calibrate_score_heads(det, [det.head.cls], True, seed + 3, math.log(0.4 / 0.6))
    model_dir = root / "models" / "SmokeFace"
    model_dir.mkdir(parents=True)
    save_file(native_face_checkpoint(det), str(model_dir / "detection.safetensors"))
    save_file(native_face_checkpoint(rec), str(model_dir / "recognition.safetensors"))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": "SmokeFace", "version": "1.0.0", "description": "seeded random weights for chip_smoke.py",
        "model_type": "face", "embedding_dim": rec_cfg.embed_dim,
        "source": {"format": "custom", "repo_id": "LumilioPhotos/SmokeFace"},
        "runtimes": {"jax": {"available": True, "files": ["detection.safetensors", "recognition.safetensors"]}},
        "extra_metadata": {
            "detector": {"input_size": det_cfg.input_size, "width": det_cfg.width, "fpn_width": det_cfg.fpn_width},
            "embedder": {"layers": list(rec_cfg.layers), "width": rec_cfg.width, "input_size": rec_cfg.input_size,
                         "embed_dim": rec_cfg.embed_dim},
        },
    }))
    return model_dir


def export_clip_towers(root: Path, name: str, cfg, state, src: Path) -> Path:
    """An export-only CLIP directory: phase 8's seeded weights in a
    float32 ``CLIPModel`` exported as ``vision.fp32.onnx`` ([B, 3, S, S]
    pixels) and ``text.fp32.onnx`` ([B, L] ids) with the plain attention
    (the causal mask a traced constant), beside phase 8's tokenizer and
    labels; no ``config.json``."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPModel, modeling
    from lumen_tpu_torch.ops.attention import attention_reference
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    model = CLIPModel(cfg)
    model.load_state_dict({k: v.float().cpu() for k, v in state.items()}, strict=True)
    model.eval()

    def export_attention(q, k, v, mask=None, causal=False, scale=None):
        if causal:
            sq, sk = q.shape[-2], k.shape[-2]
            keep = torch.from_numpy(np.tril(np.ones((sq, sk), bool), sk - sq))
            mask = keep if mask is None else mask & keep
        return attention_reference(q, k, v, mask=mask, scale=scale)

    class Vision(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            return self.m.encode_image(x.permute(0, 2, 3, 1))

    class Text(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, ids):
            return self.m.encode_text(ids)

    model_dir = root / "models" / name
    (model_dir / "datasets" / "smoke").mkdir(parents=True)
    kernel, modeling.attention = modeling.attention, export_attention
    try:
        export_onnx(Vision(), (torch.zeros(1, 3, cfg.image_size, cfg.image_size),), str(model_dir / "vision.fp32.onnx"),
                    input_names=["pixels"], dynamic_axes={"pixels": {0: "b"}})
        export_onnx(Text(), (torch.zeros(1, cfg.context_length, dtype=torch.int64),), str(model_dir / "text.fp32.onnx"),
                    input_names=["ids"], dynamic_axes={"ids": {0: "b"}})
    finally:
        modeling.attention = kernel
    shutil.copy(src / "tokenizer.json", model_dir / "tokenizer.json")
    shutil.copy(src / "datasets" / "smoke" / "labels.json", model_dir / "datasets" / "smoke" / "labels.json")
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "exported towers of chip_smoke.py's seeded CLIP",
        "model_type": "clip", "embedding_dim": cfg.embed_dim,
        "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"onnx": {"available": True, "files": ["vision.fp32.onnx", "text.fp32.onnx"]}},
        "datasets": {"Smoke1k": {"labels": "datasets/smoke/labels.json", "embeddings": "datasets/smoke/embeddings.npy"}},
    }))
    return model_dir


def face_yaml(path: Path, cache_dir: Path, services: dict) -> Path:
    """A deployment of ``services`` (name -> (model, backend settings)),
    named in their JAX form; one service is a single deployment, more a hub."""
    import yaml

    spec = {}
    for name, (model, settings) in services.items():
        family = "face" if name == "face" else "clip"
        models = {name: {"model": model, "runtime": "jax"}}
        if family == "clip":
            models[name]["dataset"] = "Smoke1k"
        spec[name] = {
            "enabled": True, "package": f"lumen_tpu.models.{family}",
            "import_info": {"registry_class": f"lumen_tpu.serving.services.{family}_service."
                                              f"{'FaceService' if family == 'face' else 'ClipService'}"},
            "backend_settings": settings, "models": models,
        }
    mode = ({"mode": "single", "service": next(iter(spec))} if len(spec) == 1
            else {"mode": "hub", "services": sorted(spec)})
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": mode, "server": {"port": 50051, "host": "127.0.0.1"}, "services": spec,
    }))
    return path


def face_pixels(jpeg: bytes, max_edge: int | None = 640):
    """The server's scaled decode of a photo: (RGB pixels, decode scale,
    original (h, w))."""
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes_scaled

    return decode_image_bytes_scaled(jpeg, color="rgb", max_edge=max_edge)


def reference_scrfd(outs, mgr, strides=(8, 16, 32)):
    """Decode of one image's raw SCRFD outputs in numpy, written from the
    reference's published algorithm (``onnxrt_backend.py:425-483,
    882-1154``), not from the port: anchor centers cell-major with 2
    anchors a cell, stride-scaled distances, the ``max_detections`` best
    by a stable descending sort, greedy IoU NMS in that order. Returns
    (boxes, kps, scores, keep) over those candidates."""
    import numpy as np

    spec, size, fmc = mgr.spec, mgr.det_cfg.input_size, len(strides)
    boxes, kps, scores = [], [], []
    for i, stride in enumerate(strides):
        s = np.asarray(outs[i], np.float32).reshape(-1)
        d = np.asarray(outs[fmc + i], np.float32).reshape(-1, 4) * stride
        k = np.asarray(outs[2 * fmc + i], np.float32).reshape(-1, 10) * stride
        n = size // stride
        gy, gx = np.mgrid[:n, :n]
        c = np.repeat(np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32) * stride, 2, axis=0)
        boxes.append(np.concatenate([c - d[:, :2], c + d[:, 2:]], 1))
        kps.append(k.reshape(-1, 5, 2) + c[:, None, :])
        scores.append(s)
    boxes, kps, scores = np.concatenate(boxes), np.concatenate(kps), np.concatenate(scores)
    top = np.argsort(-scores, kind="stable")[:spec.max_detections]
    boxes, kps, scores = boxes[top], kps[top], scores[top]
    area = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    keep = np.isfinite(scores)
    for i in range(len(boxes)):
        if not keep[i]:
            continue
        xx1 = np.maximum(boxes[i, 0], boxes[i + 1:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[i + 1:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[i + 1:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[i + 1:, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        keep[i + 1:] &= ~(inter / np.maximum(area[i] + area[i + 1:] - inter, 1e-9) > spec.nms_threshold)
    return boxes, kps, scores, keep


def gap_threshold(scores, keep, lo: int = 4, hi: int = 32) -> tuple[float, float]:
    """A confidence threshold for one photo: midway in the widest gap
    between consecutive scores of the kept (post-NMS) candidates ranked
    ``lo`` to ``hi``; returns (threshold, gap). The seeded detectors score
    on a continuum, so at a fixed threshold some photo has a candidate a
    few 1e-7 from it -- inside the difference between any two correct
    float32 computations of the same net -- and the served path and its
    reference may then keep different sets. Fewer candidates than ``lo``:
    half the lowest kept score."""
    import numpy as np

    scores = np.asarray(scores, np.float64)
    s = np.sort(scores[np.asarray(keep, bool) & np.isfinite(scores)])[::-1]
    if len(s) <= lo:
        return (float(s[-1]) / 2 if len(s) else 0.5), (float(s[-1]) / 2 if len(s) else 0.5)
    top = s[lo - 1:min(hi, len(s) - 1) + 1]
    k = int(np.argmax(top[:-1] - top[1:]))
    return float((top[k] + top[k + 1]) / 2), float(top[k] - top[k + 1])


def reference_faces(cand, spec, conf: float, max_faces: int | None = None) -> list[dict]:
    """The host half of detection in numpy, from the reference's published
    steps (``onnxrt_backend.py:1156-1210``), not from the port: kept
    candidates at or above ``conf`` by descending score, the letterbox
    undone (padding off, divided by the scale, clipped to the photo),
    degenerate boxes dropped, the longer side inside the pack's size
    gates, at most ``max_faces``. ``cand`` is one photo's reference
    candidates with its letterbox (``reference_candidates``)."""
    import numpy as np

    boxes, kps, scores, keep, scale, pad_top, pad_left, (h, w) = cand
    out = []
    for i in np.argsort(-scores, kind="stable"):
        if not keep[i] or not np.isfinite(scores[i]) or scores[i] < conf:
            continue
        box = np.clip((boxes[i].astype(np.float64) - [pad_left, pad_top, pad_left, pad_top]) / scale, 0, [w, h, w, h])
        bw, bh = box[2] - box[0], box[3] - box[1]
        if bw <= 0 or bh <= 0 or not spec.min_face <= max(bw, bh) <= spec.max_face:
            continue
        lm = (kps[i].astype(np.float64) - [pad_left, pad_top]) / scale
        out.append({"bbox": box, "confidence": float(scores[i]), "landmarks": lm})
        if max_faces is not None and len(out) >= max_faces:
            break
    return out


def box_iou(a, b) -> float:
    inter = max(0.0, min(a[2], b[2]) - max(a[0], b[0])) * max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def match_faces(served: list, ref: list, what: str) -> tuple[float, float]:
    """Served faces vs reference faces (both ``{"bbox", "confidence"}``):
    equal counts, a one-to-one match at IoU >= ``FACE_IOU``; returns (min
    IoU, max |confidence difference|)."""
    if len(served) != len(ref):
        raise AssertionError(f"{what}: {len(served)} faces served, {len(ref)} in the reference")
    left, worst, dconf = list(range(len(ref))), 1.0, 0.0
    for f in served:
        ious = [box_iou(f["bbox"], ref[j]["bbox"]) for j in left]
        j = left.pop(max(range(len(ious)), key=ious.__getitem__))
        if max(ious) < FACE_IOU:
            raise AssertionError(f"{what}: a served face matches the reference at IoU {max(ious):.5f} < {FACE_IOU}")
        worst = min(worst, max(ious))
        dconf = max(dconf, abs(f["confidence"] - ref[j]["confidence"]))
    return worst, dconf


def match_faces_tf32(served: list, cand, spec, conf: float, what: str) -> dict:
    """Served faces of the TF32 path vs the IEEE reference's candidates,
    up to score moves of ``TF32_SCORE_TOL``: each served face matches a
    distinct candidate scoring at least ``conf - TF32_SCORE_TOL`` at IoU >=
    ``FACE_IOU`` with its confidence within the tolerance; no two of those
    candidates overlap above the NMS threshold (so a candidate the
    reference suppressed is served only where its suppressor is not); each reference
    face scoring at least ``conf + TF32_SCORE_TOL`` (its longer side 1%
    inside the size gates) is served, or is covered by a served face that
    suppresses it (IoU above the NMS threshold, confidence within twice
    the tolerance: the two swapped places). Returns the min IoU, the max
    |confidence difference| and counts: faces served from below the
    threshold (``crossed``) or from a suppressed candidate
    (``unsuppressed``), reference faces not served from within the
    tolerance above it (``dropped``) or covered by a swap (``swaps``)."""
    import numpy as np

    boxes, _, scores, keep, scale, pad_top, pad_left, (h, w) = cand
    tol = TF32_SCORE_TOL
    unmapped = [np.clip((b.astype(np.float64) - [pad_left, pad_top, pad_left, pad_top]) / scale, 0, [w, h, w, h])
                for b in boxes]
    possible = [i for i in range(len(scores)) if np.isfinite(scores[i]) and scores[i] >= conf - tol]
    used = set()
    got = {"iou_min": 1.0, "dconf": 0.0, "crossed": 0, "unsuppressed": 0, "dropped": 0, "swaps": 0}
    for f in served:
        near = [i for i in possible if i not in used and abs(f["confidence"] - scores[i]) <= tol]
        ious = [box_iou(f["bbox"], unmapped[i]) for i in near]
        if not ious or max(ious) < FACE_IOU:
            raise AssertionError(f"{what}: a served face (confidence {f['confidence']:.6f}) matches no reference "
                                 f"candidate within {tol} at IoU >= {FACE_IOU} (best {max(ious, default=0.0):.5f})")
        i = near[int(np.argmax(ious))]
        used.add(i)
        got["iou_min"] = min(got["iou_min"], max(ious))
        got["dconf"] = max(got["dconf"], abs(f["confidence"] - float(scores[i])))
        got["crossed"] += int(scores[i] < conf)
        got["unsuppressed"] += int(not keep[i])
    # (on the candidates' unclipped boxes: within 0.01 of the served boxes in
    # Jaccard distance each, a metric, so served boxes that NMS kept overlap
    # at most 0.02 above its threshold there)
    matched = [boxes[i] for i in used]
    for j, a in enumerate(matched):
        for b in matched[j + 1:]:
            if box_iou(a, b) > spec.nms_threshold + 0.02:
                raise AssertionError(f"{what}: two served faces overlap at IoU {box_iou(a, b):.4f} > the NMS "
                                     f"threshold {spec.nms_threshold}")
    for r in reference_faces(cand, spec, conf):
        if any(box_iou(f["bbox"], r["bbox"]) >= FACE_IOU for f in served):
            continue
        side = max(r["bbox"][2] - r["bbox"][0], r["bbox"][3] - r["bbox"][1])
        if r["confidence"] < conf + tol or not 1.01 * spec.min_face <= side <= 0.99 * spec.max_face:
            got["dropped"] += 1
        elif any(box_iou(f["bbox"], r["bbox"]) > spec.nms_threshold
                 and abs(f["confidence"] - r["confidence"]) <= 2 * tol for f in served):
            got["swaps"] += 1
        else:
            raise AssertionError(f"{what}: a reference face (confidence {r['confidence']:.6f}, threshold "
                                 f"{conf:.6f}) is not served")
    return got


@contextlib.contextmanager
def convolutions_tf32(on: bool):
    """Run cuDNN's float32 convolutions in TF32 (``on``; PyTorch's default,
    as users run them) or in IEEE float32; restore the flag after."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def drive_face(seed: int, card: str, root: Path, phase8: dict, device: str = "cuda:0", n_photos: int = 128,
               in_flight: int = 16, batch_size: int = 16, det_width: int = 40, rec_layers=(3, 4, 14, 3),
               rec_width: int = 64, native_det=None, native_rec=None) -> dict:
    """Phase 9: face and graph CLIP as users reach them. (a) the
    ``buffalo_l`` stand-in pack served over gRPC, timed and held against
    the stand-in modules run directly, once with TF32 convolutions as users
    run them (to ``TF32_SCORE_TOL``) and once in IEEE float32 (strictly);
    (b) native checkpoints of ``DetectorConfig()`` / ``IResNetConfig()``
    held against the port's own CPU run; (c) phase 8's CLIP exported to
    ONNX and served from an export-only directory, held against phase 8's
    answers; (d) a hub of clip (native) + face. The sizes and counts let
    the CPU tests rehearse it small."""
    import logging
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    import torch

    from lumen_tpu_torch.models.face import DetectorConfig, FaceManager, IResNetConfig
    from lumen_tpu_torch.ops.image import letterbox_numpy
    from lumen_tpu_torch.ops.nms import nms_torch
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    dev = torch.device(device)
    native_det = native_det or DetectorConfig()
    native_rec = native_rec or IResNetConfig()
    out: dict = {}
    # The references run their convolutions in IEEE float32, and so does the
    # served path wherever it is held to them strictly: the seeded detectors
    # score anchors on a continuum, and TF32's rounding moves candidates
    # across the score threshold and the top-k cut. Users run the served path
    # in TF32 (PyTorch's default for cuDNN): (a) times it so and holds it to
    # the reference up to TF32_SCORE_TOL, and (c) serves graph CLIP so.
    t0 = time.perf_counter()
    _, det, rec = write_face_pack(root / "cache", seed * 100 + 9, det_width, rec_layers, rec_width)
    export_s = time.perf_counter() - t0
    n_det = sum(t.numel() for t in det.state_dict().values())
    n_rec = sum(t.numel() for t in rec.state_dict().values())
    photos = face_photos(seed * 100 + 90, n_photos + 16)
    warm, photos = photos[n_photos:], photos[:n_photos]
    log(f"phase 9: buffalo_l stand-in pack exported on the CPU in {export_s:.1f} s: det_10g.onnx "
        f"({n_det:,} params, 640x640, 9 outputs), w600k_r50.onnx ({n_rec:,} params, 112x112 -> 512); "
        f"{n_photos + 16} distinct 1280x1280 JPEGs with bright discs")
    det, rec = det.to(dev), rec.to(dev)

    def direct_embed(mgr, crops):
        x = torch.from_numpy(np.stack(crops)).to(dev).float()
        with convolutions_tf32(False), torch.no_grad():
            z = rec(((x - mgr.spec.rec_mean) / mgr.spec.rec_std).permute(0, 3, 1, 2)).float()
        return (z / z.norm(dim=-1, keepdim=True)).cpu().numpy()

    def reference_candidates(mgr, pixels_list):
        """Reference candidates of pre-decoded photos ((pixels, decode
        scale, original hw) each): the stand-in run directly on the
        letterboxed photos in IEEE float32, ``batch_size`` at a time,
        decoded by ``reference_scrfd``; with each photo's letterbox."""
        boxed = [letterbox_numpy(p, mgr.det_cfg.input_size) for p, _, _ in pixels_list]
        raw = []
        for lo in range(0, len(boxed), batch_size):
            x = torch.from_numpy(np.stack([b for b, _, _, _ in boxed[lo:lo + batch_size]])).to(dev).float()
            with convolutions_tf32(False), torch.no_grad():
                outs = [o.cpu().numpy() for o in det(((x - mgr.spec.det_mean) / mgr.spec.det_std).permute(0, 3, 1, 2))]
            raw += [[o[i] for o in outs] for i in range(len(x))]
        return [(*reference_scrfd(r, mgr), scale * dscale, pt, pl, hw)
                for r, (_, scale, pt, pl), (_, dscale, hw) in zip(raw, boxed, pixels_list)]

    def embed_reference(mgr, pixels, faces, dscale):
        crops = []
        for f in faces:
            crop = mgr.align_crop(pixels, np.asarray(f["landmarks"], np.float32) * dscale)
            crops.append(np.ascontiguousarray(crop[:, :, ::-1] if mgr.spec.rec_color == "bgr" else crop))
        return direct_embed(mgr, crops) if crops else np.zeros((0, 512))

    def drive(stub, task, payloads, metas, mime="image/jpeg"):
        """``payloads`` over gRPC at ``in_flight``; (answers, wall s)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            res = list(ex.map(lambda p, m: grpc_call(stub, task, p, m, mime=mime), payloads, metas))
        wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 9: {task} answered codes {sorted({r['code'] for r in res})}")
        return res, wall

    # -- (a) the pack over gRPC ------------------------------------------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    settings = {"dtype": "bfloat16", "batch_size": batch_size, "warmup": True}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            face_yaml(root / "face.yaml", root / "cache", {"face": ("buffalo_l", settings)}), device)
    try:
        mgr = handle.services["face"].manager
        db, rb = mgr._det_batcher, mgr._rec_batcher
        placed = [t.device for v in (mgr.det_vars, mgr.rec_vars) for t in v.values()]
        if any(d != dev for d in placed):
            raise AssertionError(f"phase 9 (a): bridge params on {sorted({str(d) for d in placed})}, not {dev}")
        log(f"phase 9 (a): face server up in {load_s:.2f} s (serve() to the first Health ok, graphs loaded, "
            f"placed and warmed: det buckets {db.buckets}, rec buckets {rb.buckets}); spec det "
            f"{mgr.spec.det_size} score {mgr.spec.score_threshold} nms {mgr.spec.nms_threshold} faces "
            f"{mgr.spec.min_face}-{mgr.spec.max_face} px, rec {mgr.spec.rec_color} [{card}]")
        with convolutions_tf32(True):
            _, cold_s = drive(stub, "face_detect", warm, [{}] * len(warm))
        log(f"phase 9 (a): cold round (decode workers starting): {len(warm)} photos in {cold_s:.3f} s")

        # Each photo is asked at a confidence threshold midway in the
        # widest gap of its reference's kept scores (``gap_threshold``).
        decoded = [face_pixels(p) for p in photos]
        cands = reference_candidates(mgr, decoded)
        thr, gaps = zip(*(gap_threshold(c[2], c[3]) for c in cands))
        thr_meta = [{"conf_threshold": t} for t in thr]
        n_de = min(8, n_photos)
        crops, lms, crop_refs = [], [], []
        for i in range(n_de):
            px = decode_image_bytes(photos[i], color="rgb")
            y0, x0 = 200 + 40 * i, 300 + 50 * i
            ok, buf = cv2.imencode(".png", np.ascontiguousarray(px[y0:y0 + 240, x0:x0 + 200, ::-1]))
            crops.append(buf.tobytes())
            lm = None if i % 2 else [[70, 100], [130, 100], [100, 140], [75, 180], [125, 180]]
            lms.append({} if lm is None else {"landmarks": json.dumps(lm)})
            cpx = decode_image_bytes(crops[-1], color="rgb")
            crop = mgr.align_crop(cpx, np.asarray(lm, np.float32)) if lm else mgr._center_crop(cpx)
            crop_refs.append(direct_embed(mgr, [np.ascontiguousarray(crop[:, :, ::-1] if mgr.spec.rec_color == "bgr"
                                                                     else crop)])[0])
        crop_refs = np.stack(crop_refs)

        # As users run it: TF32 convolutions, timed; held to the reference
        # up to TF32_SCORE_TOL.
        before = dict(db.stats)
        with convolutions_tf32(True):
            detected, wall = drive(stub, "face_detect", photos, thr_meta)
            embedded, _ = drive(stub, "face_embed", crops, lms, mime="image/png")
        batches, items = db.stats["batches"] - before["batches"], db.stats["items"] - before["items"]
        fill = items / max(batches * db.buckets[-1], 1)
        lat = sorted(r["s"] * 1e3 for r in detected)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        tf32 = {"iou_min": 1.0, "dconf": 0.0, "crossed": 0, "unsuppressed": 0, "dropped": 0, "swaps": 0}
        n_faces_t = 0
        for i, r in enumerate(detected):
            got = match_faces_tf32(r["body"]["faces"], cands[i], mgr.spec, thr[i], f"phase 9 (a) TF32 photo {i}")
            tf32 = {k: (min if k == "iou_min" else max if k == "dconf" else sum)((v, got[k])) for k, v in tf32.items()}
            n_faces_t += len(r["body"]["faces"])
        cos_tf32 = float(cosines(np.asarray([r["body"]["faces"][0]["embedding"] for r in embedded]), crop_refs).min())
        if n_faces_t == 0:
            raise AssertionError("phase 9 (a): no face detected in any photo")
        if cos_tf32 < FACE_COSINE:
            raise AssertionError(f"phase 9 (a): TF32 face_embed cosine to the stand-in {cos_tf32:.6f} < {FACE_COSINE}")
        log(f"phase 9 (a), TF32 convolutions as users run them: {n_photos} face_detect over gRPC ({in_flight} in "
            f"flight) in {wall:.3f} s = {n_photos / wall:.1f} photos/s; client p50 {pct(0.5):.1f} ms p95 "
            f"{pct(0.95):.1f} ms; {batches} detector batches, mean fill {100 * fill:.1f}% of {db.buckets[-1]}; "
            f"{n_faces_t} faces, each matched to a candidate of the IEEE stand-in run directly within "
            f"{TF32_SCORE_TOL} (IoU min {tf32['iou_min']:.5f}, tol {FACE_IOU}; |confidence| diff max "
            f"{tf32['dconf']:.2e}; {tf32['crossed']} served from below the threshold, {tf32['unsuppressed']} from a "
            f"candidate the reference suppressed, {tf32['dropped']} reference faces not served from within the "
            f"tolerance above it, {tf32['swaps']} covered by a swap); {n_de} face_embed (half with landmarks) "
            f"cosine min {cos_tf32:.6f} (tol {FACE_COSINE}) [{card}]")

        # IEEE float32: the same photos, held to the reference strictly.
        reset_result_cache()
        with convolutions_tf32(False):
            detected, wall_ieee = drive(stub, "face_detect", photos, thr_meta)
            both, _ = drive(stub, "face_detect_and_embed", photos[:n_de],
                            [{"max_faces": 4, **m} for m in thr_meta[:n_de]])
            embedded, _ = drive(stub, "face_embed", crops, lms, mime="image/png")
            worst, dconf, n_faces = 1.0, 0.0, 0
            for i, r in enumerate(detected):
                ref = reference_faces(cands[i], mgr.spec, thr[i])
                w, d = match_faces(r["body"]["faces"], ref, f"phase 9 (a) photo {i}")
                worst, dconf, n_faces = min(worst, w), max(dconf, d), n_faces + len(ref)
            log(f"phase 9 (a), IEEE float32: the {n_photos} face_detect in {wall_ieee:.3f} s = "
                f"{n_photos / wall_ieee:.1f} photos/s; {n_faces} faces, each matched one to one to the stand-in run "
                f"directly (IoU min {worst:.5f}, tol {FACE_IOU}; |confidence| diff max {dconf:.2e}; thresholds "
                f"{min(thr):.4f}-{max(thr):.4f} in score gaps >= {min(gaps):.2e}) [{card}]")

            # detect-and-embed (JPEG), embed (crops, with and without landmarks), tensor/raw
            cos_min, n_emb = float(cosines(np.asarray([r["body"]["faces"][0]["embedding"] for r in embedded]),
                                           crop_refs).min()), 0
            for i, r in enumerate(both):
                faces = r["body"]["faces"]
                match_faces(faces, reference_faces(cands[i], mgr.spec, thr[i], max_faces=4),
                            f"phase 9 (a) detect_and_embed photo {i}")
                if faces:
                    want = embed_reference(mgr, decoded[i][0], faces, decoded[i][1])
                    cos_min = min(cos_min, float(cosines(np.stack([f["embedding"] for f in faces]), want).min()))
                    n_emb += len(faces)
            for i in range(min(4, n_photos)):
                px = decode_image_bytes(photos[i], color="rgb")
                payload, tmeta = tensor_payload(px)
                cand = reference_candidates(mgr, [(px, 1.0, px.shape[:2])])[0]
                t = gap_threshold(cand[2], cand[3])[0]
                for task in ("face_detect", "face_detect_and_embed"):
                    r = grpc_call(stub, task, payload, {**tmeta, "max_faces": 4, "conf_threshold": t}, mime=TENSOR_MIME)
                    if r["code"]:
                        raise AssertionError(f"phase 9 (a): tensor/raw {task} code {r['code']}")
                    ref = reference_faces(cand, mgr.spec, t, max_faces=4)
                    match_faces(r["body"]["faces"], ref, f"phase 9 (a) tensor/raw {task} photo {i}")
                    if task == "face_detect_and_embed" and r["body"]["faces"]:
                        want = embed_reference(mgr, px, r["body"]["faces"], 1.0)
                        cos_min = min(cos_min, float(cosines(
                            np.stack([f["embedding"] for f in r["body"]["faces"]]), want).min()))
        if cos_min < FACE_COSINE:
            raise AssertionError(f"phase 9 (a): embedding cosine to the stand-in {cos_min:.6f} < {FACE_COSINE}")
        log(f"phase 9 (a), IEEE float32: {n_de} face_detect_and_embed ({n_emb} faces), {n_de} face_embed (half "
            f"with landmarks) and 4 photos as tensor/raw (face_detect, face_detect_and_embed): detections matched, "
            f"embedding cosine to the stand-in run directly min {cos_min:.6f} (tol {FACE_COSINE})")

        # device-side costs of one batch of 16, on the card
        if on_card:
            boxed = np.stack([letterbox_numpy(p, 640)[0] for p, _, _ in decoded[:batch_size]])
            batch = torch.from_numpy(boxed).to(dev)
            crops16 = torch.from_numpy(np.stack([np.ascontiguousarray(mgr._center_crop(p)) for p, _, _ in
                                                 decoded[:batch_size]])).to(dev)
            with convolutions_tf32(False):
                outs = [o.cpu() for o in mgr._run_detector(mgr.det_vars, batch)]
                if any(o.device != dev for o in mgr._run_detector(mgr.det_vars, batch)):
                    raise AssertionError("phase 9 (a): a detector output is not on the card")
                det_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, batch), 10)
                rec_ms = cuda_ms(lambda: mgr._run_embedder(mgr.rec_vars, crops16), 10)
                ieee_emb = mgr._run_embedder(mgr.rec_vars, crops16).cpu().numpy()
                boxes, _, scores, _ = mgr._run_detector(mgr.det_vars, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nms_torch(boxes, scores, mgr.spec.nms_threshold)
                nms_host_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    nms_torch(boxes, scores, mgr.spec.nms_threshold)
                    torch.cuda.synchronize()
                nms_launches = sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
                syncs = {"detector": count_syncs(lambda: mgr._run_detector(mgr.det_vars, batch)),
                         "embedder": count_syncs(lambda: mgr._run_embedder(mgr.rec_vars, crops16))}
            with convolutions_tf32(True):
                det_tf32_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, batch), 10)
                rec_tf32_ms = cuda_ms(lambda: mgr._run_embedder(mgr.rec_vars, crops16), 10)
                tf32_outs = [o.cpu() for o in mgr._run_detector(mgr.det_vars, batch)]
                tf32_emb = mgr._run_embedder(mgr.rec_vars, crops16).cpu().numpy()
            same = int((outs[3] == tf32_outs[3]).all(-1).sum())
            cos_batch = float(cosines(tf32_emb, ieee_emb).min())
            log(f"phase 9 (a): one detector batch of {batch_size} at 640x640 {det_ms:.3f} ms on the device "
                f"(CUDA events, launch path, decode and NMS included; IEEE float32), {det_tf32_ms:.3f} ms with "
                f"TF32 convolutions; one embedder batch of {batch_size} crops {rec_ms:.3f} ms ({rec_tf32_ms:.3f} ms "
                f"TF32); NMS over {boxes.shape[1]} candidates x {boxes.shape[0]} images: {nms_launches} launches, "
                f"{nms_host_ms:.2f} ms of host time; device-to-host syncs per forward {json.dumps(syncs)}; "
                f"TF32 vs IEEE on the same batch: candidate scores max |diff| "
                f"{float((outs[2] - tf32_outs[2]).abs().max()):.2e}, keep masks equal in {same} of {batch_size} "
                f"images, embeddings cosine min {cos_batch:.6f} (tol {FACE_COSINE}) [{card}]")
            if cos_batch < FACE_COSINE:
                raise AssertionError(f"phase 9 (a): TF32 embeddings vs IEEE cosine {cos_batch:.6f} < {FACE_COSINE}")
            out.update(det_ms=det_ms, det_tf32_ms=det_tf32_ms, rec_ms=rec_ms, rec_tf32_ms=rec_tf32_ms,
                       nms_launches=nms_launches, nms_host_ms=nms_host_ms, syncs=syncs)
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        out.update(load_s=load_s, photos_s=n_photos / wall, photos_s_ieee=n_photos / wall_ieee, p50_ms=pct(0.5),
                   p95_ms=pct(0.95), fill=fill, faces=n_faces, iou_min=worst, cos_min=cos_min, tf32=tf32,
                   peak_gib=peak)
        face_answers = {i: r["body"]["faces"] for i, r in enumerate(detected[:8])}
        # what phase 10's hub holds its faces to
        out.update(face_photos=photos[:8], face_thr=list(thr[:8]), face_answers=face_answers)
    finally:
        channel.close()
        handle.stop(grace=1.0)

    # -- (b) native checkpoints: the card against the port's CPU run, IEEE --------
    reset_result_cache()
    native_dir = write_native_face_dir(root / "cache", seed * 100 + 19, native_det, native_rec)
    n_b = min(6, n_photos)
    t0 = time.perf_counter()
    cpu = FaceManager(str(native_dir), dtype="float32", batch_size=batch_size, device="cpu")
    cpu.initialize()
    try:
        # thresholds from the CPU run's candidates, as (a)'s from the reference's
        thr_b, gaps_b = [], []
        for p in photos[:n_b]:
            _, _, sc, keep = cpu._det_batcher(letterbox_numpy(face_pixels(p)[0], cpu.det_cfg.input_size)[0])
            t, g = gap_threshold(sc, keep)
            thr_b.append(t)
            gaps_b.append(g)
        as_dicts = lambda faces: [{"bbox": f.bbox, "confidence": f.confidence} for f in faces]  # noqa: E731
        refs_b = [as_dicts(cpu.detect_faces(p, conf_threshold=t)) for p, t in zip(photos[:n_b], thr_b)]
        refs_be = [cpu.detect_and_extract(p, max_faces=3, conf_threshold=t) for p, t in zip(photos[:n_b], thr_b)]
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t0
    reset_result_cache()
    settings = {"dtype": "float32", "batch_size": batch_size}
    handle, channel, stub, native_load_s = boot_server(
        face_yaml(root / "native.yaml", root / "cache", {"face": ("SmokeFace", settings)}), device)
    try:
        with convolutions_tf32(False):
            served_d, _ = drive(stub, "face_detect", photos[:n_b], [{"conf_threshold": t} for t in thr_b])
            served_de, _ = drive(stub, "face_detect_and_embed", photos[:n_b],
                                 [{"max_faces": 3, "conf_threshold": t} for t in thr_b])
    finally:
        channel.close()
        handle.stop(grace=1.0)
    worst_b, cos_b, n_b_faces = 1.0, 1.0, 0
    for i in range(n_b):
        worst_b = min(worst_b, match_faces(served_d[i]["body"]["faces"], refs_b[i], f"phase 9 (b) photo {i}")[0])
        n_b_faces += len(refs_b[i])
        got = served_de[i]["body"]["faces"]
        match_faces(got, as_dicts(refs_be[i]), f"phase 9 (b) detect_and_embed photo {i}")
        if got:
            cos_b = min(cos_b, float(cosines(np.stack([f["embedding"] for f in got]),
                                             np.stack([f.embedding for f in refs_be[i]])).min()))
    if n_b_faces == 0:
        raise AssertionError("phase 9 (b): no face detected in any photo")
    if cos_b < FACE_COSINE:
        raise AssertionError(f"phase 9 (b): embedding cosine card vs CPU {cos_b:.6f} < {FACE_COSINE}")
    log(f"phase 9 (b): native checkpoints (DetectorConfig {native_det.input_size}/{native_det.width}, "
        f"IResNetConfig {list(native_rec.layers)}/{native_rec.width} -> {native_rec.embed_dim}, seeded, float32) "
        f"served in {native_load_s:.2f} s; {n_b} face_detect + {n_b} face_detect_and_embed in IEEE float32 equal "
        f"to the port's own CPU run ({cpu_s:.1f} s): {n_b_faces} faces, IoU min {worst_b:.5f}, embeddings cosine "
        f"min {cos_b:.6f} (thresholds in score gaps >= {min(gaps_b):.2e}) [{card}]")

    # -- (c) CLIP from an export-only directory, as users run it (TF32) ----------
    reset_result_cache()
    cfg8 = phase8["cfg"]
    t0 = time.perf_counter()
    clip_dir = export_clip_towers(root / "cache", "SmokeMobileCLIP", cfg8, phase8["state"],
                                  root / "cache" / "models" / "SmokeCLIP")
    clip_export_s = time.perf_counter() - t0
    mb = sum(f.stat().st_size for f in clip_dir.glob("*.onnx")) / 2**20
    records: list[logging.LogRecord] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keeper = Keep(logging.WARNING)
    logging.getLogger("lumen_tpu_torch.models.clip.manager").addHandler(keeper)
    try:
        settings = {"dtype": "bfloat16", "batch_size": batch_size, "quantize": "int8"}
        with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
            handle, channel, stub, clip_load_s = boot_server(
                face_yaml(root / "clipgraph.yaml", root / "cache", {"clip": ("SmokeMobileCLIP", settings)}),
                device)
    finally:
        logging.getLogger("lumen_tpu_torch.models.clip.manager").removeHandler(keeper)
    try:
        cm = handle.services["clip"].managers["clip"]
        if cm._graphs is None or not any("quantize=int8 ignored" in r.getMessage() for r in records):
            raise AssertionError("phase 9 (c): not graph-served, or quantize=int8 accepted without the warning")
        if any(t.device != dev for part in cm.model.values() for t in part.values()):
            raise AssertionError("phase 9 (c): a tower param is not on the card")
        with convolutions_tf32(True):
            images, _ = drive(stub, "clip_image_embed", phase8["photos"], [{}] * len(phase8["photos"]))
            texts, _ = drive(stub, "clip_text_embed", [t.encode() for t in phase8["texts"]],
                             [{}] * len(phase8["texts"]), mime="text/plain")
            labels, _ = drive(stub, "clip_classify", phase8["photos"][:4], [{"top_k": 5}] * 4)
        cos_i = cosines(np.stack([r["body"]["vector"] for r in images]), phase8["vecs"])
        cos_t = cosines(np.stack([r["body"]["vector"] for r in texts]), phase8["tvecs"])
        cos_l = cosines(cm._label_matrix, phase8["label_matrix"])
        cos_c = float(min(cos_i.min(), cos_t.min(), cos_l.min()))
        if cos_c < CLIP_COSINE:
            raise AssertionError(f"phase 9 (c): cosine to phase 8's native answers {cos_c:.6f} < {CLIP_COSINE}")
        for r, v in zip(labels, images):
            sims = cm._label_matrix @ np.asarray(v["body"]["vector"], np.float32)
            top = [cm.label_names[j] for j in np.argsort(-sims)[:5]]
            if [x["label"] for x in r["body"]["labels"]] != top:
                raise AssertionError("phase 9 (c): classify labels are not the embedding's top 5")
        clip_syncs = None
        if on_card:
            pix = torch.from_numpy(np.stack([np.zeros((cm.cfg.image_size,) * 2 + (3,), np.uint8)] * batch_size)).to(dev)
            clip_syncs = count_syncs(lambda: cm._encode_images(cm.model, pix))
        log(f"phase 9 (c): phase 8's CLIP exported to ONNX on the CPU in {clip_export_s:.1f} s ({mb:.0f} MiB), "
            f"export-only directory served in {clip_load_s:.2f} s with quantize: int8 ignored (warned; "
            f"{len(cm.label_names)} label embeddings through the text graph in {cm.label_embed_s:.2f} s); "
            f"{len(images)} clip_image_embed, {len(texts)} clip_text_embed, 4 clip_classify with TF32 "
            f"convolutions: cosine to phase 8's native answers min {cos_c:.6f} (images {cos_i.min():.6f}, texts "
            f"{cos_t.min():.6f}, labels {cos_l.min():.6f}; tol {CLIP_COSINE}); device-to-host syncs per vision "
            f"forward {clip_syncs} [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    out.update(export_s=export_s, clip_export_s=clip_export_s, clip_load_s=clip_load_s, clip_cos=cos_c)

    # -- (d) a hub of clip (native) + face, IEEE (held to (a)'s answers) ----------
    reset_result_cache()
    flash = next(k for k in all_kernels() if k.name == "flash_attention")
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(face_yaml(root / "facehub.yaml", root / "cache", {
            "clip": ("SmokeCLIP", {"dtype": "bfloat16", "batch_size": batch_size}),
            "face": ("buffalo_l", {"dtype": "bfloat16", "batch_size": batch_size})}), device)
    try:
        cm = handle.services["clip"].managers["clip"]
        before = cm._image_batcher.stats["batches"]
        flash.launches = 0
        n_d = min(8, n_photos)

        def job(i):
            if i < n_d:
                return grpc_call(stub, "face_detect", photos[i], {"conf_threshold": thr[i]})
            return grpc_call(stub, "clip_image_embed", phase8["photos"][i - n_d], {})

        with convolutions_tf32(False), ThreadPoolExecutor(2 * n_d) as ex:
            res = list(ex.map(job, range(2 * n_d)))
        hub_launches = flash.launches
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 9 (d): codes {[r['code'] for r in res]}")
        for i in range(n_d):
            match_faces(res[i]["body"]["faces"], face_answers[i], f"phase 9 (d) photo {i} vs (a)")
        cos_d = cosines(np.stack([r["body"]["vector"] for r in res[n_d:]]), phase8["vecs"][:n_d])
        if cos_d.min() < CLIP_COSINE:
            raise AssertionError(f"phase 9 (d): hub embeddings vs phase 8's, cosine {cos_d.min():.6f}")
        need = cfg8.vision.layers * (cm._image_batcher.stats["batches"] - before)
        for name in PHASE9_KERNELS:
            if hub_launches < need or need == 0:
                raise AssertionError(f"phase 9 (d): {name} launched {hub_launches} times, need {need} "
                                     f"(vision layers x image batches)")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    live = [t.name for t in threading.enumerate() if t.name.startswith(("face-", "clip-"))]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 9 (d): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 9 (d): hub of clip (native) + face up in {hub_s:.2f} s; {n_d} face_detect beside {n_d} "
        f"clip_image_embed: faces equal to (a)'s, embeddings cosine min {cos_d.min():.6f} to phase 8's; "
        f"flash_attention launches {hub_launches}; stop retired "
        f"{len([t for t in threads if t.startswith(('face-', 'clip-'))])} batcher threads and the decode "
        f"pool's {len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, hub_launches=hub_launches, phase_s=time.perf_counter() - t_phase)
    return out

# -- phase 10: OCR over gRPC, and the full tier ----------------------------------------

#: the kernels phase 10 (b) must launch (the native recognizer's mixing
#: blocks, head_dim 16) and those of (c)'s full-tier hub
PHASE10_KERNELS = ("flash_attention",)
PHASE10_HUB_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
#: the flash kernel's head_dim-16 calls of the native SVTR (width 64, 4
#: heads): a chunk of 8 crops in the 320 bucket and 32 in the 640 bucket
OCR_FLASH_SHAPES = {"SVTR 320 bucket": (8, 4, 960), "SVTR 640 bucket": (32, 4, 1920)}
#: exponentials a second of the H100 SXM's special-function units: 16 a
#: clock on each of 132 SMs at the 1.98 GHz boost clock (NVIDIA H100 data
#: sheet and Hopper tuning guide); the third term of the head_dim-16 bound
EXP_PER_S = 16 * 132 * 1.98e9
#: (a)/(b) in IEEE float32: every box matches its reference at this IoU
OCR_IOU = 0.999
#: (a) with TF32 convolutions, as users run it: at least OCR_TF32_SHARE of
#: the IEEE reference's boxes are served at IoU >= OCR_TF32_IOU, and at
#: most 1 - OCR_TF32_SHARE of the served boxes match none. TF32 rounds
#: the detector's map by about 1e-3 (phase 9's TF32 scores moved up to
#: 6.55e-4), which moves pixels across the threshold at the lines' edges
#: and so the contours' corners by a pixel or two.
OCR_TF32_IOU, OCR_TF32_SHARE = 0.9, 0.95
#: (b) bf16: the kernel path's CTC logits within this share of the plain
#: path's largest |logit| (bf16 rounds each layer's output to 2**-9; the
#: kernel and the plain attention round in different places)
OCR_BF16_LOGIT_SHARE = 0.05


def ocr_pages(seed: int, n: int, width: int = 1280, height: int = 960, rotated_share: float = 0.25):
    """``n`` distinct seeded synthetic pages (dark text lines drawn with
    ``cv2.putText`` on a light ground, a share of them turned 180 degrees)
    as JPEG bytes, with their pixels as the server decodes them."""
    import cv2
    import numpy as np

    from lumen_tpu_torch.testing.ocr_standins import synthetic_page
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes

    out = []
    for i in range(n):
        page, _ = synthetic_page(seed + i, width, height, rotated_share=rotated_share)
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(page[:, :, ::-1]), [cv2.IMWRITE_JPEG_QUALITY, 92])
        if not ok:
            raise AssertionError("JPEG encode failed")
        out.append((buf.tobytes(), decode_image_bytes(buf.tobytes(), color="rgb")))
    return out


def gap_between(values, center: float, half: float) -> tuple[float, float]:
    """A threshold midway in the widest gap between ``values`` within
    ``half`` of ``center`` (the interval's ends count as values), and the
    gap: no rounding of a value by less than half the gap moves it across.
    Phase 9's ``gap_threshold`` idea, for thresholds a request can set."""
    import numpy as np

    v = np.unique(np.asarray(values, np.float64).ravel())
    pts = np.concatenate([[center - half], v[(v > center - half) & (v < center + half)], [center + half]])
    k = int(np.argmax(np.diff(pts)))
    return float((pts[k] + pts[k + 1]) / 2), float(pts[k + 1] - pts[k])


def ref_quad_iou(a, b) -> float:
    """IoU of two convex quads; two quads of no area (a box clipped flat
    at the page's edge) count as equal when their corners are."""
    import cv2
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    inter, _ = cv2.intersectConvexConvex(a, b)
    union = cv2.contourArea(a) + cv2.contourArea(b) - inter
    if union < 1e-9:
        return float(np.abs(a - b).max() < 1e-3)
    return float(inter / union)


class OcrReference:
    """The PP-OCR pipeline written from the reference's published steps
    (``lumen_ocr/backends/onnxrt_backend.py:338-632``, with the JAX
    package's letterbox buckets and rectangle unclip), not from the port:
    the stand-in modules run directly on the card in IEEE float32, the
    host steps in numpy and cv2. ``answer`` returns the items a request
    with the given thresholds must get."""

    def __init__(self, det, rec, cls, vocab, dev, det_buckets=(320, 640, 960), rec_buckets=(80, 160, 320, 640)):
        self.det, self.rec, self.cls, self.vocab, self.dev = det, rec, cls, vocab, dev
        self.det_buckets, self.rec_buckets = det_buckets, rec_buckets

    def _norm(self, pixels, mean, std):
        import numpy as np
        import torch

        x = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.dev).float() / 255.0
        return ((x - torch.tensor(mean, device=self.dev)) / torch.tensor(std, device=self.dev)).permute(0, 3, 1, 2)

    def prob_map(self, pixels):
        """(map of the letterboxed page, scale, pad top, pad left)."""
        import torch

        from lumen_tpu_torch.ops.image import letterbox_numpy

        bucket = next((b for b in self.det_buckets if max(pixels.shape[:2]) <= b), self.det_buckets[-1])
        boxed, scale, top, left = letterbox_numpy(pixels, bucket)
        with convolutions_tf32(False), torch.no_grad():
            prob = self.det(self._norm(boxed[None], (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))[0, 0]
        return prob.cpu().numpy(), scale, top, left

    @staticmethod
    def candidates(prob, det_thr, unclip=1.5, min_size=3.0):
        """(rect, quad, score) of each contour of the thresholded map: the
        min-area rectangle, its mean probability, the rectangle grown by
        ``area * unclip / perimeter`` on each side."""
        import cv2
        import numpy as np

        binary = (prob > det_thr).astype(np.uint8)
        contours, _ = cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        h, w = prob.shape
        out = []
        for c in contours[:1000]:
            rect = cv2.minAreaRect(c)
            if min(rect[1]) < min_size:
                continue
            pts = cv2.boxPoints(rect)
            x0, x1 = int(np.clip(np.floor(pts[:, 0].min()), 0, w - 1)), int(np.clip(np.ceil(pts[:, 0].max()), 0, w - 1))
            y0, y1 = int(np.clip(np.floor(pts[:, 1].min()), 0, h - 1)), int(np.clip(np.ceil(pts[:, 1].max()), 0, h - 1))
            mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
            cv2.fillPoly(mask, [np.round(pts - [x0, y0]).astype(np.int32)], 1)
            score = float(cv2.mean(prob[y0:y1 + 1, x0:x1 + 1], mask)[0]) if mask.any() else 0.0
            (cx, cy), (rw, rh), ang = rect
            d = rw * rh * unclip / max(2.0 * (rw + rh), 1e-9)
            grown = ((cx, cy), (rw + 2 * d, rh + 2 * d), ang)
            if min(grown[1]) < min_size + 2:
                continue
            out.append((grown, score))
        return out

    @staticmethod
    def quad(rect, scale, top, left, hw):
        """The grown rectangle's corners clockwise from the top-left, in
        the page's coordinates."""
        import cv2
        import numpy as np

        pts = cv2.boxPoints(rect)
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        lft, rgt = pts[:2][np.argsort(pts[:2, 1], kind="stable")], pts[2:][np.argsort(pts[2:, 1], kind="stable")]
        q = np.array([lft[0], rgt[0], rgt[1], lft[1]], np.float32)
        q[:, 0] = np.clip((q[:, 0] - left) / scale, 0, hw[1] - 1)
        q[:, 1] = np.clip((q[:, 1] - top) / scale, 0, hw[0] - 1)
        return q

    @staticmethod
    def reading_order(quads):
        order = sorted(range(len(quads)), key=lambda i: (quads[i][0][1], quads[i][0][0]))
        for j in range(len(order) - 1):
            for k in range(j, -1, -1):
                a, b = quads[order[k]], quads[order[k + 1]]
                if abs(b[0][1] - a[0][1]) < 10 and b[0][0] < a[0][0]:
                    order[k], order[k + 1] = order[k + 1], order[k]
                else:
                    break
        return order

    @staticmethod
    def crop(pixels, q):
        import cv2
        import numpy as np

        w = max(int(max(np.linalg.norm(q[0] - q[1]), np.linalg.norm(q[2] - q[3]))), 1)
        h = max(int(max(np.linalg.norm(q[0] - q[3]), np.linalg.norm(q[1] - q[2]))), 1)
        m = cv2.getPerspectiveTransform(q, np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32))
        c = cv2.warpPerspective(pixels, m, (w, h), borderMode=cv2.BORDER_REPLICATE, flags=cv2.INTER_CUBIC)
        return np.rot90(c) if h / w >= 1.5 else c

    def flips(self, crops, thresh=0.9):
        import cv2
        import numpy as np
        import torch

        batch = np.zeros((len(crops), 48, 192, 3), np.uint8)
        for i, c in enumerate(crops):
            nw = min(max(int(round(c.shape[1] * 48 / max(c.shape[0], 1))), 1), 192)
            batch[i, :, :nw] = cv2.resize(c, (nw, 48), interpolation=cv2.INTER_LINEAR)
        with convolutions_tf32(False), torch.no_grad():
            p = self.cls(self._norm(batch, (0.5,) * 3, (0.5,) * 3)).cpu().numpy()
        return [bool(r.argmax() == 1 and r[1] > thresh) for r in p], p[:, 1]

    def read(self, crops):
        """(text, confidence) of each crop: height 48, the width bucket,
        one batch a bucket, CTC greedy over the valid steps."""
        import cv2
        import numpy as np
        import torch

        out = [None] * len(crops)
        groups: dict = {}
        for i, c in enumerate(crops):
            nw = max(int(round(c.shape[1] * 48 / max(c.shape[0], 1))), 1)
            b = next((x for x in self.rec_buckets if nw <= x), self.rec_buckets[-1])
            groups.setdefault(b, []).append((i, cv2.resize(c, (min(nw, b), 48), interpolation=cv2.INTER_LINEAR)))
        for b, items in groups.items():
            batch = np.zeros((len(items), 48, b, 3), np.uint8)
            for row, (_, r) in enumerate(items):
                batch[row, :, :r.shape[1]] = r
            with convolutions_tf32(False), torch.no_grad():
                probs = self.rec(self._norm(batch, (0.5,) * 3, (0.5,) * 3)).float().cpu().numpy()
            t = probs.shape[1]
            for row, (i, r) in enumerate(items):
                ids, conf = probs[row].argmax(-1), probs[row].max(-1)
                valid = np.arange(t) * max(b // t, 1) < r.shape[1]
                prev, chars, confs = -1, [], []
                for k in range(t):
                    idx = int(ids[k]) if valid[k] else 0
                    if idx != 0 and idx != prev and idx < len(self.vocab):
                        chars.append(self.vocab[idx])
                        confs.append(float(conf[k]))
                    prev = idx
                out[i] = ("".join(chars), float(np.mean(confs)) if confs else 1.0)
        return out

    def answer(self, pixels, det_thr, box_thr, rec_thr, angle: bool, cand=None):
        """The items (quad, text, confidence) a request must get, with every
        box's confidence and classifier probability: (items, confidences,
        probabilities)."""
        import numpy as np

        prob, scale, top, left = cand or self.prob_map(pixels)
        quads = [self.quad(r, scale, top, left, pixels.shape[:2])
                 for r, s in self.candidates(prob, det_thr) if s >= box_thr]
        order = self.reading_order(quads)
        quads = [quads[i] for i in order]
        crops = [self.crop(pixels, q) for q in quads]
        p_cls = []
        if angle and crops:
            flips, p_cls = self.flips(crops)
            crops = [np.ascontiguousarray(c[::-1, ::-1]) if f else c for c, f in zip(crops, flips)]
        texts = self.read(crops) if crops else []
        items = [(q, t, c) for q, (t, c) in zip(quads, texts) if t and c >= rec_thr]
        return items, [c for _, c in texts], list(p_cls)


def match_ocr(served: list, ref: list, what: str, iou: float = OCR_IOU) -> tuple[float, float]:
    """Served items (``{"box", "text", "confidence"}``) against reference
    items ((quad, text, confidence)): equal counts, one to one at IoU >=
    ``iou`` with equal texts; returns (min IoU, max |confidence diff|)."""
    import numpy as np

    if len(served) != len(ref):
        raise AssertionError(f"{what}: {len(served)} items served, {len(ref)} in the reference")
    left, worst, dconf = list(range(len(ref))), 1.0, 0.0
    for item in served:
        ious = [ref_quad_iou(item["box"], ref[j][0]) for j in left]
        j = left.pop(int(np.argmax(ious)))
        if max(ious) < iou or item["text"] != ref[j][1]:
            raise AssertionError(f"{what}: a served item matches the reference at IoU {max(ious):.5f} (tol {iou}), "
                                 f"text {item['text']!r} vs {ref[j][1]!r}, box {np.asarray(item['box']).tolist()} vs "
                                 f"{np.asarray(ref[j][0]).tolist()}")
        worst = min(worst, max(ious))
        dconf = max(dconf, abs(item["confidence"] - ref[j][2]))
    return worst, dconf


def ocr_yaml(path: Path, cache_dir: Path, services: dict) -> Path:
    """A deployment in the shape ``generate_config`` writes (hub mode, each
    service's ``backend_settings`` with the preset's ``mesh`` and
    ``max_batch_latency_ms``), services named in their JAX form; ``services``
    maps a family to (model, settings)."""
    import yaml

    classes = {"ocr": "OcrService", "clip": "ClipService", "face": "FaceService", "vlm": "VlmService",
               "search": "SearchService"}
    spec = {}
    for family, (model, settings) in services.items():
        models = {family: {"model": model, "runtime": "jax"}}
        if family == "clip":
            models["clip"]["dataset"] = "Smoke1k"
        spec[family] = {
            "enabled": True, "package": f"lumen_tpu.serving.services.{family}_service",
            "import_info": {"registry_class": f"lumen_tpu.serving.services.{family}_service.{classes[family]}"},
            "backend_settings": {"mesh": {"axes": {"data": -1}}, "max_batch_latency_ms": 5.0, **settings},
            "models": models,
        }
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": list(spec)},
        "server": {"port": 50051, "host": "127.0.0.1", "mdns": {"enabled": False, "service_name": "lumen-tpu"}},
        "services": spec,
    }, sort_keys=False))
    return path


def drive_ocr(seed: int, card: str, root: Path, phase6: dict, phase8: dict, phase9: dict, device: str = "cuda:0",
              n_pages: int = 32, in_flight: int = 8, page_hw=(960, 1280), pack_kw: dict | None = None,
              native=None, n_native: int = 3) -> dict:
    """Phase 10: OCR as users reach it, and the full tier. (a) the
    ``PP-OCRv5_mobile`` stand-in pack served from the YAML block
    ``config_gen`` writes for ``ocr``, timed with TF32 convolutions and held
    to ``OcrReference`` up to ``OCR_TF32_*``, then held strictly in IEEE
    float32, with ``tensor/raw`` pages and ``use_angle_cls``; (b) native
    ``DBNetConfig()`` + ``SVTRConfig()`` + ``ClsConfig()`` (``native``:
    their configs) served in bf16 on the head_dim-16 flash kernel against
    the port's plain path, and in float32 against the port's CPU run; (c)
    a full-tier hub (ocr, clip, face, vlm) from one YAML. The sizes let the
    CPU tests rehearse it small."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.ocr import ClsConfig, DBNetConfig, OcrManager, SVTRConfig
    from lumen_tpu_torch.models.ocr import modeling as ocr_modeling
    from lumen_tpu_torch.ops.ctc import load_ctc_vocab
    from lumen_tpu_torch.ops.image import letterbox_numpy
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.testing.ocr_standins import write_native_ocr_dir, write_ppocr_pack
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    det_bucket = next((b for b in (320, 640, 960) if max(page_hw) <= b), 960)
    out: dict = {}
    kernels = {k.name: k for k in all_kernels()}

    def drive(stub, jobs):
        """``jobs`` (payload, meta, mime) over gRPC at ``in_flight``:
        (answers, wall s)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            res = list(ex.map(lambda j: grpc_call(stub, "ocr", j[0], j[1], mime=j[2]), jobs))
        wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 10: ocr answered codes {sorted({r['code'] for r in res})}")
        return res, wall

    # -- (a) the stand-in pack over gRPC --------------------------------------------
    t0 = time.perf_counter()
    pack_dir = root / "cache" / "models" / "PP-OCRv5_mobile"
    mods = write_ppocr_pack(pack_dir, seed * 100 + 10, page_hw=page_hw, det_bucket=det_bucket, **(pack_kw or {}))
    export_s = time.perf_counter() - t0
    n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in mods.items()}
    pages = ocr_pages(seed * 100 + 100, n_pages, width=page_hw[1], height=page_hw[0])
    vocab = load_ctc_vocab(str(pack_dir / "ppocr_keys_v1.txt"))
    log(f"phase 10: PP-OCRv5_mobile stand-in pack exported on the CPU in {export_s:.1f} s: det.onnx ({n_par['det']:,} "
        f"params), rec.onnx ({n_par['rec']:,} params, {len(vocab)} classes), cls.onnx ({n_par['cls']:,} params); "
        f"{n_pages} distinct {page_hw[1]}x{page_hw[0]} JPEG pages of text lines")
    ref = OcrReference(*(mods[k].to(dev).eval() for k in ("det", "rec", "cls")), vocab, dev)
    # Each page is asked at thresholds in the widest gaps of its reference's
    # values: the map's near 0.3, the box scores near 0.6, the confidences
    # near 0.5, so no rounding can tip an answer (as phase 9's gap_threshold).
    n_cls = min(8, n_pages)  # pages asked with use_angle_cls
    asks, gaps = [], []
    for i, (_, px) in enumerate(pages):
        cand = ref.prob_map(px)
        det_thr, g1 = gap_between(cand[0], 0.3, 0.1)
        box_thr, g2 = gap_between([sc for _, sc in ref.candidates(cand[0], det_thr)], 0.6, 0.1)
        items, confs, p_cls = ref.answer(px, det_thr, box_thr, 0.0, i < n_cls, cand=cand)
        rec_thr, g3 = gap_between(confs, 0.5, 0.1)
        items = [it for it in items if it[2] >= rec_thr]
        if p_cls and min(abs(np.asarray(p_cls) - 0.9)) < 1e-4:
            log(f"phase 10 (a): page {i}: a classifier probability within 1e-4 of cls_thresh 0.9")
        asks.append(dict(meta={"det_thresh": det_thr, "box_thresh": box_thr, "rec_thresh": rec_thr,
                               "use_angle_cls": "true" if i < n_cls else "false"}, items=items))
        gaps.append(min(g1, g2, g3))
    n_items = sum(len(a["items"]) for a in asks)
    if n_items == 0:
        raise AssertionError("phase 10 (a): the reference reads no text on any page")
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            ocr_yaml(root / "ocr.yaml", root / "cache", {"ocr": ("PP-OCRv5_mobile", settings)}), device)
    try:
        mgr = handle.services["ocr"].manager
        placed = {t.device for v in (mgr.det_vars, mgr.rec_vars, mgr.cls_vars) for t in v.values()}
        if placed != {dev} or not mgr.has_angle_cls:
            raise AssertionError(f"phase 10 (a): bridge params on {placed}, cls {mgr.has_angle_cls}")
        jobs = [(jpeg, a["meta"], "image/jpeg") for (jpeg, _), a in zip(pages, asks)]
        with convolutions_tf32(True):
            drive(stub, jobs[:in_flight])  # cold round: decode workers start, cuDNN picks its algorithms
            reset_result_cache()
            served, wall = drive(stub, jobs)
        lat = sorted(r["s"] * 1e3 for r in served)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        tf32 = {"ref": n_items, "served": 0, "matched": 0, "exact": 0, "moved": 0, "texts": 0}
        for r, a in zip(served, asks):
            items, left = r["body"]["items"], list(range(len(a["items"])))
            tf32["served"] += len(items)
            for it in items:
                ious = [ref_quad_iou(it["box"], a["items"][j][0]) for j in left]
                if not ious or max(ious) < OCR_TF32_IOU:
                    continue
                j = left.pop(int(np.argmax(ious)))
                tf32["matched"] += 1
                same = it["text"] == a["items"][j][1]
                tf32["exact"] += int(max(ious) >= OCR_IOU and same)
                tf32["moved"] += int(max(ious) < OCR_IOU)
                tf32["texts"] += int(not same)
        if tf32["matched"] < OCR_TF32_SHARE * n_items or tf32["served"] - tf32["matched"] > (1 - OCR_TF32_SHARE) * n_items:
            raise AssertionError(f"phase 10 (a): TF32 answers vs the IEEE reference {tf32} (tol {OCR_TF32_SHARE} "
                                 f"of the boxes at IoU >= {OCR_TF32_IOU})")
        log(f"phase 10 (a), TF32 convolutions as users run them: {n_pages} ocr over gRPC ({in_flight} in flight, "
            f"{n_cls} with use_angle_cls) in {wall:.3f} s = {n_pages / wall:.2f} pages/s; client p50 {pct(0.5):.1f} ms "
            f"p95 {pct(0.95):.1f} ms; {tf32['served']} items against the IEEE reference's {n_items}: {tf32['matched']} "
            f"at IoU >= {OCR_TF32_IOU} (tol {OCR_TF32_SHARE} of them), {tf32['exact']} equal (IoU >= {OCR_IOU}, same "
            f"text), {tf32['moved']} moved, {tf32['texts']} texts differ [{card}]")

        # IEEE float32: the same pages and more, held strictly.
        reset_result_cache()
        with convolutions_tf32(False):
            strict, wall_ieee = drive(stub, jobs)
            n_raw = min(4, n_pages)
            raw = [tensor_payload(px) for _, px in pages[:n_raw]]
            tensors, _ = drive(stub, [(p, {**m, **a["meta"]}, TENSOR_MIME) for (p, m), a in zip(raw, asks)])
            plain_jobs = [(jpeg, {**a["meta"], "use_angle_cls": "false"}, "image/jpeg")
                          for (jpeg, _), a in zip(pages[:n_cls], asks)]
            as_is, _ = drive(stub, plain_jobs)
        worst, dconf = 1.0, 0.0
        for i, r in enumerate(strict + tensors):
            w, d = match_ocr(r["body"]["items"], asks[i % n_pages]["items"], f"phase 10 (a) page {i % n_pages}")
            worst, dconf = min(worst, w), max(dconf, d)
        flipped = 0
        for i, r in enumerate(as_is):
            px = pages[i][1]
            meta = asks[i]["meta"]
            want = ref.answer(px, meta["det_thresh"], meta["box_thresh"], meta["rec_thresh"], False)[0]
            match_ocr(r["body"]["items"], want, f"phase 10 (a) page {i} without the classifier")
            flipped += sum(a[1] != b[1] for a, b in zip(want, asks[i]["items"]))
        log(f"phase 10 (a), IEEE float32: the {n_pages} pages in {wall_ieee:.3f} s = {n_pages / wall_ieee:.2f} pages/s, "
            f"{n_raw} as tensor/raw, {n_cls} again without use_angle_cls: {n_items} items each matched one to one to the "
            f"stand-ins run directly (IoU min {worst:.5f}, tol {OCR_IOU}; texts equal; |confidence| diff max "
            f"{dconf:.2e}; thresholds in gaps >= {min(gaps):.2e}); the classifier changed {flipped} texts [{card}]")

        # device-side costs, on the card
        if on_card:
            boxed = np.stack([letterbox_numpy(px, det_bucket)[0] for _, px in pages[:1]])
            x_det = torch.from_numpy(boxed).to(dev)
            chunk = torch.from_numpy(np.zeros((16, 48, 320, 3), np.uint8)).to(dev)
            widths = torch.full((16,), 320, dtype=torch.int32, device=dev)
            with convolutions_tf32(True):
                det_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, x_det), 10)
                rec_ms = cuda_ms(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths), 10)
            with convolutions_tf32(False):
                det_ieee_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, x_det), 10)
                rec_ieee_ms = cuda_ms(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths), 10)
                syncs = {"detector": count_syncs(lambda: mgr._run_detector(mgr.det_vars, x_det)),
                         "recognizer": count_syncs(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths))}
                prob = mgr._run_detector(mgr.det_vars, x_det)[0].cpu().numpy()
            from lumen_tpu_torch.models.ocr import rotate_crop

            # the host's share of a page: contours, boxes and crops of the
            # first 8 pages' maps, after the one copy
            probs = []
            for _, px in pages[:8]:
                boxed1, sc, top, left = letterbox_numpy(px, det_bucket)
                with convolutions_tf32(False):
                    probs.append((mgr._run_detector(mgr.det_vars, torch.from_numpy(boxed1[None]).to(dev))[0].cpu()
                                  .numpy(), sc, top, left, px))
            t0 = time.perf_counter()
            n_crops = 0
            for (prob, sc, top, left, px), a in zip(probs, asks):
                found = mgr.boxes_from_det_output(prob, image_hw=px.shape[:2], scale=sc, pad_top=top, pad_left=left,
                                                  det_threshold=a["meta"]["det_thresh"],
                                                  box_threshold=a["meta"]["box_thresh"])
                n_crops += len([rotate_crop(px, q) for q, _ in found])
            post_ms = (time.perf_counter() - t0) * 1e3 / len(probs)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"phase 10 (a): one detector call at {det_bucket}x{det_bucket} {det_ms:.3f} ms with TF32 convolutions ({det_ieee_ms:.3f} ms "
                f"IEEE), one recognizer chunk of 16 crops at 48x320 {rec_ms:.3f} ms ({rec_ieee_ms:.3f} ms IEEE; CUDA "
                f"events, launch path included); host postprocess {post_ms:.2f} ms a page (contours, boxes, "
                f"{n_crops / len(probs):.1f} crops; the first {len(probs)} pages); device-to-host syncs per forward {json.dumps(syncs)}; peak {peak:.3f} GiB [{card}]")
            out.update(det_ms=det_ms, det_ieee_ms=det_ieee_ms, rec_ms=rec_ms, rec_ieee_ms=rec_ieee_ms, post_ms=post_ms,
                       syncs=syncs, peak_gib=peak)
        out.update(load_s=load_s, export_s=export_s, pages_s=n_pages / wall, pages_s_ieee=n_pages / wall_ieee,
                   p50_ms=pct(0.5), p95_ms=pct(0.95), items=n_items, iou_min=worst, tf32=tf32,
                   ocr_answers={i: (pages[i][0], asks[i]["meta"], strict[i]["body"]["items"]) for i in range(n_cls)})
    finally:
        channel.close()
        handle.stop(grace=1.0)
    ref.det, ref.rec, ref.cls = (m.cpu() for m in (ref.det, ref.rec, ref.cls))
    out["a_s"] = time.perf_counter() - t_phase

    # -- (b) native checkpoints: bf16 on the head_dim-16 kernel, float32 vs the CPU --------
    det_cfg, rec_cfg, cls_cfg = native or (DBNetConfig(), SVTRConfig(), ClsConfig())
    t0 = time.perf_counter()
    native_dir = root / "cache" / "models" / "SmokeOCR"
    write_native_ocr_dir(native_dir, seed * 100 + 20, det_cfg, rec_cfg, cls_cfg, page_hw=page_hw,
                         det_bucket=det_bucket)
    write_s = time.perf_counter() - t0
    npages = pages[:n_native]
    flash = kernels["flash_attention"]
    reset_result_cache()
    settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, bf16_load_s = boot_server(
            ocr_yaml(root / "native.yaml", root / "cache", {"ocr": ("SmokeOCR", settings)}), device)
    try:
        mgr = handle.services["ocr"].manager
        chunks, captured = [], []
        run_rec = mgr._run_recognizer

        def counted(variables, crops, widths):
            chunks.append(tuple(crops.shape))
            captured.append((crops.clone(), widths.clone()))
            return run_rec(variables, crops, widths)

        mgr._run_recognizer = counted
        meta = {"det_thresh": 0.3, "box_thresh": 0.3, "rec_thresh": 0.0, "use_angle_cls": "true"}
        flash.launches = 0
        served_b, _ = drive(stub, [(jpeg, meta, "image/jpeg") for jpeg, _ in npages])
        launches = flash.launches
        mgr._run_recognizer = run_rec
        for name in PHASE10_KERNELS:  # once a mixing block, in every recognizer chunk
            if kernels[name].launches != rec_cfg.layers * len(chunks) or not chunks:
                raise AssertionError(f"phase 10 (b): {name} launched {kernels[name].launches} times for "
                                     f"{len(chunks)} recognizer chunks of {rec_cfg.layers} layers")
        # Each recognizer chunk the server ran, again through the kernel and
        # through the port's plain path (attention_reference in the mixing
        # blocks) on the same batch: the logits within OCR_BF16_LOGIT_SHARE
        # of the plain path's largest |logit|, and the same argmax at every
        # valid step whose plain top-two margin exceeds twice the row's
        # difference (where no rounding of that size can swap them).
        worst_d, n_rows, n_held = 0.0, 0, 0
        for crops, widths in captured:
            x = ((crops.float() / 255.0 - 0.5) / 0.5).to(mgr.policy.compute_dtype).permute(0, 3, 1, 2)
            with torch.no_grad():
                k_logits = mgr.rec_vars(x).float()
                with plain_attention(ocr_modeling):
                    p_logits = mgr.rec_vars(x).float()
            scale = float(p_logits.abs().max())
            diff = (k_logits - p_logits).abs().amax(dim=(1, 2))  # per row
            worst_d = max(worst_d, float(diff.max()) / scale)
            if float(diff.max()) > OCR_BF16_LOGIT_SHARE * scale:
                raise AssertionError(f"phase 10 (b): bf16 logits kernel vs plain {float(diff.max()):.3e} > "
                                     f"{OCR_BF16_LOGIT_SHARE} x {scale:.3e}")
            t = p_logits.shape[1]
            valid = torch.arange(t, device=dev)[None] * max(crops.shape[2] // t, 1) < widths[:, None]
            top2 = p_logits.topk(2, dim=-1).values
            held = (top2[..., 0] - top2[..., 1] > 2 * diff[:, None]) & valid
            if not bool((k_logits.argmax(-1) == p_logits.argmax(-1))[held].all()):
                raise AssertionError("phase 10 (b): a bf16 step's argmax differs from the plain path's where the "
                                     "margin exceeds twice the logit difference")
            live = widths > 0
            n_rows += int(live.sum())
            n_held += int((held | ~valid).all(1)[live].sum())
        # The same pages through the plain path end to end: equal boxes,
        # texts counted.
        reset_result_cache()  # (the served answers are in it, under the same options)
        with plain_attention(ocr_modeling):
            plain_b = [mgr.predict(jpeg, det_threshold=0.3, box_threshold=0.3, rec_threshold=0.0, use_angle_cls=True)
                       for jpeg, _ in npages]
        n_equal, n_b = 0, 0
        for r, want in zip(served_b, plain_b):
            items = r["body"]["items"]
            if len(items) != len(want) or any(ref_quad_iou(it["box"], w.box) < OCR_IOU for it, w in zip(items, want)):
                raise AssertionError("phase 10 (b): the bf16 boxes differ from the plain path's")
            n_b += len(items)
            n_equal += sum(it["text"] == w.text for it, w in zip(items, want))
        log(f"phase 10 (b): native DBNetConfig {det_cfg.width}/{det_cfg.fpn_width}/{det_cfg.head_width} + SVTRConfig "
            f"{rec_cfg.width}x{rec_cfg.layers} ({rec_cfg.heads} heads of {rec_cfg.width // rec_cfg.heads}, vocab "
            f"{rec_cfg.vocab_size}) + ClsConfig {list(cls_cfg.channels)} (seeded, calibrated) written in {write_s:.1f} "
            f"s, served in bf16 in {bf16_load_s:.2f} s: {len(npages)} pages, {n_b} items with boxes equal to the plain "
            f"path's; each recognizer chunk rerun on both paths: CTC logits within {worst_d:.2e} of the plain path's "
            f"largest |logit| (tol {OCR_BF16_LOGIT_SHARE}), every step's argmax equal where the margin allows ("
            f"{n_held} of {n_rows} crops held whole); texts equal to the plain path's in {n_equal} of {n_b}; "
            f"flash_attention (head_dim 16) launches {launches} = {rec_cfg.layers} x {len(chunks)} recognizer chunks "
            f"{sorted(set(chunks))} [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)

    # float32: the card (IEEE) against the port's own CPU run of the same manager
    t0 = time.perf_counter()
    cpu = OcrManager(str(native_dir), dtype="float32", device="cpu", det_buckets=(320, 640, 960))
    cpu.initialize()
    try:
        metas, refs = [], []
        for jpeg, px in npages:
            boxed, _, _, _ = letterbox_numpy(px, det_bucket)
            prob = cpu._run_detector(cpu.det_vars, torch.from_numpy(boxed[None]))[0].numpy()
            det_thr, _ = gap_between(prob, 0.3, 0.1)
            # (box scores of the seeded net's fragmented contours run lower than
            # a trained one's: the box threshold comes from 0.2-0.6)
            scores = [s for _, s in cpu.detect(px, det_threshold=det_thr, box_threshold=0.0)]
            box_thr, _ = gap_between(scores, 0.4, 0.2)
            confs = [r.confidence for r in cpu.predict_tensor(px, det_threshold=det_thr, box_threshold=box_thr,
                                                              rec_threshold=0.0, use_angle_cls=True)]
            rec_thr, _ = gap_between(confs, 0.5, 0.1)
            m = {"det_thresh": det_thr, "box_thresh": box_thr, "rec_thresh": rec_thr, "use_angle_cls": "true"}
            metas.append(m)
            refs.append([(r.box, r.text, r.confidence) for r in cpu.predict(
                jpeg, det_threshold=det_thr, box_threshold=box_thr, rec_threshold=rec_thr, use_angle_cls=True)])
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t0
    reset_result_cache()
    settings = {"dtype": "float32", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    handle, channel, stub, f32_load_s = boot_server(
        ocr_yaml(root / "native32.yaml", root / "cache", {"ocr": ("SmokeOCR", settings)}), device)
    try:
        with convolutions_tf32(False):
            served_f, _ = drive(stub, [(jpeg, m, "image/jpeg") for (jpeg, _), m in zip(npages, metas)])
    finally:
        channel.close()
        handle.stop(grace=1.0)
    worst_f, n_f = 1.0, 0
    for i, (r, want) in enumerate(zip(served_f, refs)):
        worst_f = min(worst_f, match_ocr(r["body"]["items"], want, f"phase 10 (b) float32 page {i}")[0])
        n_f += len(want)
    if n_f == 0:
        raise AssertionError("phase 10 (b): the CPU run reads no text on any page")
    log(f"phase 10 (b): float32 served in {f32_load_s:.2f} s; {len(npages)} pages ({n_f} items) equal to the port's "
        f"own CPU run ({cpu_s:.1f} s): IoU min {worst_f:.5f}, texts equal [{card}]")
    out.update(native_launches=launches, native_chunks=len(chunks), bf16_logit_share=worst_d, native_items=n_f,
               b_s=time.perf_counter() - t_phase - out["a_s"])

    # -- (c) the full tier: ocr + clip + face + vlm from one YAML ------------------------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    tier = {
        "ocr": ("PP-OCRv5_mobile", {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}),
        "clip": ("SmokeCLIP", {"dtype": "bfloat16", "batch_size": 64}),
        "face": ("buffalo_l", {"dtype": "bfloat16", "batch_size": 16}),
        "vlm": ("SmokeVLM", {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [64, 128, 256, 512, 1024]}),
    }
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(4 * in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(ocr_yaml(root / "full.yaml", root / "cache", tier), device)
    try:
        from google.protobuf import empty_pb2

        _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        status = json.loads(dict(call_.trailing_metadata())["lumen-service-status"])
        if status != {name: "healthy" for name in tier} or any(getattr(s, "error", None) for s in handle.services.values()):
            raise AssertionError(f"phase 10 (c): service status {status}")
        for k in kernels.values():
            k.launches = 0
        n_vlm, n_img = 4, min(8, len(phase8["photos"]))
        n_face, n_ocr = min(4, len(phase9["face_photos"])), len(out["ocr_answers"])
        jobs = ([("vlm_generate_stream", phase6["photos"][i], {"messages": phase6["prompt"],
                                                              "max_new_tokens": phase6["budgets"][i]}, "image/jpeg")
                 for i in range(n_vlm)]
                + [("clip_image_embed", phase8["photos"][i], {}, "image/jpeg") for i in range(n_img)]
                + [("face_detect", phase9["face_photos"][i], {"conf_threshold": phase9["face_thr"][i]}, "image/jpeg")
                   for i in range(n_face)]
                + [("ocr", jpeg, meta, "image/jpeg") for jpeg, meta, _ in out["ocr_answers"].values()])
        t0 = time.perf_counter()
        with convolutions_tf32(False), ThreadPoolExecutor(len(jobs)) as ex:
            res = list(ex.map(lambda j: grpc_call(stub, j[0], j[1], j[2], mime=j[3]), jobs))
        hub_wall = time.perf_counter() - t0
        hub_launches = {name: kernels[name].launches for name in PHASE10_HUB_KERNELS}
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 10 (c): codes {[r['code'] for r in res]}")
        for i in range(n_vlm):
            want = phase6["streams"][i]
            if (res[i]["body"]["text"], res[i]["body"]["generated_tokens"]) != (want["text"], want["generated_tokens"]):
                raise AssertionError(f"phase 10 (c): caption stream {i} differs from phase 6's")
        cos = cosines(np.stack([r["body"]["vector"] for r in res[n_vlm:n_vlm + n_img]]), phase8["vecs"][:n_img])
        if cos.min() < CLIP_COSINE:
            raise AssertionError(f"phase 10 (c): embeddings vs phase 8's, cosine {cos.min():.6f}")
        for i in range(n_face):
            match_faces(res[n_vlm + n_img + i]["body"]["faces"], phase9["face_answers"][i], f"phase 10 (c) face {i}")
        for i, (_, _, want) in enumerate(out["ocr_answers"].values()):
            got = res[n_vlm + n_img + n_face + i]["body"]["items"]
            match_ocr(got, [(w["box"], w["text"], w["confidence"]) for w in want], f"phase 10 (c) page {i}")
        missing = [k for k, n in hub_launches.items() if n == 0 and k in PHASE10_HUB_KERNELS]
        if missing:
            raise AssertionError(f"phase 10 (c): never launched: {missing} ({hub_launches})")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    prefixes = ("face-", "clip-", "vlm-continuous")
    live = [t.name for t in threading.enumerate() if t.name.startswith(prefixes)]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 10 (c): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 10 (c): the full tier (ocr, clip, face, vlm; one YAML in generate_config's shape) up in {hub_s:.2f} s, "
        f"every service healthy; {n_vlm} caption streams, {n_img} clip_image_embed, {n_face} face_detect and {n_ocr} "
        f"ocr at once in {hub_wall:.3f} s: captions equal to phase 6's, embeddings cosine min {cos.min():.6f} to "
        f"phase 8's, faces as phase 9's, OCR items as (a)'s; launches {json.dumps(hub_launches)}; stop retired "
        f"{len([t for t in threads if t.startswith(prefixes)])} batcher/engine threads and the decode pool's "
        f"{len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, hub_launches=hub_launches, tier=tier, phase_s=time.perf_counter() - t_phase)
    return out


# -- phase 11: bulk ingest through the CLI, and search over gRPC ------------------

#: the kernels phase 11 (a)'s ingest must launch: the CLIP vision tower in
#: the dense sweep, the VLM's prefill and decode in the captions
PHASE11_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
#: (a): an ingested CLIP embedding against the served one of the same
#: pixels (both IEEE float32 convolutions; bf16 towers batched differently)
INGEST_COSINE = 0.9999
#: (b): served scores against the numpy oracle's (float32 products summed
#: in other orders), and the gap between the oracle's 10th and 11th
#: scores below which a query counts as a near-tie
SEARCH_SCORE_TOL = 1e-5
#: the H100 SXM's float32 rate outside the tensor cores (the ANN products
#: run IEEE float32; NVIDIA data sheet, dense)
FP32_FLOPS = 67e12
#: the CLI's default caption prompt
CAPTION_PROMPT = "Describe this photo in one sentence."


def ingest_photos(seed: int, n: int, width: int = 1600, height: int = 1200) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs: every fourth a page of dark
    text lines on a light ground (the OCR stand-ins' input), the rest
    tinted gradients with a little noise and three to five discs, bright
    ones on every fourth (offset 1: the face stand-ins' input). (Noise of
    std 10 makes the OCR stand-in read about a hundred boxes of noise a
    photo; at std 4 it reads two or three.)"""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from lumen_tpu_torch.testing.ocr_standins import synthetic_page

    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)

    def one(i: int) -> bytes:
        rng = np.random.default_rng(seed * 1000 + i)
        if i % 4 == 0:
            img = synthetic_page(seed * 1000 + i, width, height, lines=12)[0][:, :, ::-1]
        else:
            img = base * rng.uniform(40, 200, 3) + rng.normal(0, 4, (height, width, 3))
            lo = 200 if i % 4 == 1 else 0
            for _ in range(int(rng.integers(3, 6))):
                cx, cy, r = int(rng.integers(0, width)), int(rng.integers(0, height)), int(rng.integers(40, 150))
                cv2.circle(img, (cx, cy), r, tuple(float(v) for v in rng.uniform(lo, 255, 3)), -1)
        ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        return buf.tobytes()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def oracle_topk(scores, ids: list, k: int) -> tuple[list, list, float]:
    """``exact_oracle``'s answer from one column of precomputed scores
    (every row scoring at least the k-th score, ordered by score
    descending, then id ascending), and the gap between the k-th and the
    (k+1)-th scores."""
    import numpy as np

    top = np.sort(np.partition(scores, -(k + 1))[-(k + 1):])[::-1]
    cand = np.nonzero(scores >= top[k - 1])[0]
    order = sorted(cand, key=lambda i: (-float(scores[i]), ids[i]))[:k]
    return [ids[i] for i in order], [float(scores[i]) for i in order], float(top[k - 1] - top[k])


def match_near(got: list, want: list, thr: float, tol: float, what: str, iou_min: float, iou, same) -> dict:
    """One-to-one match of two answers computed from the same pixels in
    different batches: every item of either side scoring at least ``thr +
    tol`` matches an item of the other at ``iou >= iou_min`` with its
    confidence within ``tol`` and ``same(got, want)``; items within ``tol``
    above the threshold may be missing from the other side (counted as
    ``near``). Returns the min IoU, the matched and near counts."""
    left, out = list(range(len(want))), {"iou_min": 1.0, "matched": 0, "near": 0}
    for g in got:
        ious = [iou(g, want[j]) for j in left]
        j = left[max(range(len(ious)), key=ious.__getitem__)] if ious else None
        if j is not None and max(ious) >= iou_min and abs(g["confidence"] - want[j]["confidence"]) <= tol:
            if not same(g, want[j]):
                raise AssertionError(f"{what}: a matched item differs: {g} vs {want[j]}")
            left.remove(j)
            out["matched"] += 1
            out["iou_min"] = min(out["iou_min"], float(max(ious)))
        elif g["confidence"] < thr + tol:
            out["near"] += 1
        else:
            raise AssertionError(f"{what}: an ingested item (confidence {g['confidence']:.5f}, threshold {thr}) "
                                 f"matches no served item (best IoU {max(ious, default=0.0):.4f})")
    for j in left:
        if want[j]["confidence"] >= thr + tol:
            raise AssertionError(f"{what}: a served item (confidence {want[j]['confidence']:.5f}) was not ingested")
        out["near"] += 1
    return out


def drive_ingest(seed: int, card: str, root: Path, phase8: dict, phase9: dict, phase10: dict, device: str = "cuda:0",
                 n_photos: int = 128, n_captions: int = 16, n_square: int = 32, batch_size: int = 64,
                 photo_hw=(1200, 1600),
                 caption_tokens: int = 32, n_vectors: int = 200_000, chunk: int = 1024, n_queries: int = 512,
                 in_flight: int = 16) -> dict:
    """Phase 11: bulk ingest and search as users reach them, on phase 10
    (c)'s full tier plus ``search`` from one YAML. (a) ``n_photos`` distinct
    seeded JPEGs through ``python -m lumen_tpu_torch.pipeline.cli`` (called
    in process) with ``--families clip,face,ocr``, then ``n_captions`` of
    them again with ``vlm``; every row held to the served per-request
    answers of the same pixels, IEEE float32 convolutions on both sides;
    then a warm re-run on the server's managers: all cache hits, no kernel
    launch, ``index=`` fired on every hit into the search service. (b)
    ``n_vectors`` seeded unit vectors upserted over gRPC, ``n_queries``
    ``search_query`` calls held to the numpy oracle, and queries during an
    upsert flood. The sizes let the CPU tests rehearse it small."""
    import base64
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    import torch

    import lumen_tpu_torch.pipeline.photo as photo_mod
    from lumen_tpu_torch.pipeline import cli
    from lumen_tpu_torch.runtime.ann import _score_topk, ann_tile, exact_oracle, normalize
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.fleet import fleet_devices
    from lumen_tpu_torch.runtime.mesh import build_mesh
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes_scaled
    from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, TENSOR_MIME, pack_bundle, tensor_payload

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    kernels = {k.name: k for k in all_kernels()}
    dim = len(phase8["vecs"][0])
    out: dict = {}
    work = root / "ingest"
    photos_dir, caps_dir = work / "photos", work / "captions"
    photos_dir.mkdir(parents=True)
    caps_dir.mkdir()
    photos = ingest_photos(seed * 100 + 11, n_photos, width=photo_hw[1], height=photo_hw[0])
    for i, jpeg in enumerate(photos):
        (photos_dir / f"p{i:03d}.jpg").write_bytes(jpeg)
        if i < n_captions:
            (caps_dir / f"p{i:03d}.jpg").write_bytes(jpeg)
    tier = {**phase10["tier"], "search": ("ann-exact", {"batch_size": in_flight, "max_batch_latency_ms": 2.0})}
    yaml_path = ocr_yaml(work / "tier.yaml", root / "cache", tier)
    platform = [] if on_card else ["--platform", "cpu"]
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def ask(job) -> dict:
        r = grpc_call(stub, job[0], job[1], job[2], mime=job[3])
        if r["code"]:
            raise AssertionError(f"phase 11: {job[0]} answered code {r['code']}")
        return r

    def raw(arr) -> tuple[bytes, dict]:
        payload, meta = tensor_payload(np.ascontiguousarray(arr))
        return bytes(payload), meta

    # (a run on the CPU keeps the second server to one intra-op thread)
    vlm_server = ServerProcess("the VLM server", ocr_yaml(work / "vlm.yaml", root / "cache", {"vlm": tier["vlm"]}),
                               free_port(), device, work / "vlm_server.log",
                               {"LUMEN_VLM_SPEC_K": "0", "LUMEN_GRPC_WORKERS": str(in_flight + 8), "LUMEN_DRAIN_S": "0",
                                **({} if on_card else {"OMP_NUM_THREADS": "1"})})
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_ANN_DIM=str(dim), LUMEN_GRPC_WORKERS=str(4 * in_flight + 8)):
        try:
            handle, channel, stub, boot_s = boot_server(yaml_path, device)
        except BaseException:
            vlm_server.stop()
            raise
        try:
            from google.protobuf import empty_pb2

            _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
            status = json.loads(dict(call_.trailing_metadata())["lumen-service-status"])
            if status != {name: "healthy" for name in tier}:
                raise AssertionError(f"phase 11: service status {status}")
            clip_mgr = handle.services["clip"].managers["clip"]
            face_mgr, ocr_mgr = handle.services["face"].manager, handle.services["ocr"].manager
            size = clip_mgr.cfg.image_size
            max_edge = max(size, face_mgr.det_cfg.input_size, max(ocr_mgr.spec.det_buckets))

            # -- (a) served answers (tenant "served": their cache entries never
            # answer the ingest's default-tenant lookups, nor the reverse) ------
            with ThreadPoolExecutor(8) as ex:
                decoded = list(ex.map(lambda j: decode_image_bytes_scaled(j, color="rgb", max_edge=max_edge), photos))
            served_meta = {"tenant": "served"}
            jobs = [("clip_image_embed", *raw(cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)),
                     TENSOR_MIME) for img, _, _ in decoded]
            disc_idx = [i for i in range(n_photos) if i % 4 == 1]
            page_idx = [i for i in range(n_photos) if i % 4 == 0]
            jobs += [("face_detect_and_embed", *raw(decoded[i][0]), TENSOR_MIME) for i in disc_idx]
            jobs += [("ocr", *raw(decoded[i][0]), TENSOR_MIME) for i in page_idx]
            square = phase9["face_photos"][:n_square]
            jobs += [("face_detect_and_embed", jpeg, {}, "image/jpeg") for jpeg in square]
            for job in jobs:
                job[2].update(served_meta)
            t0 = time.perf_counter()
            with convolutions_tf32(False), ThreadPoolExecutor(in_flight) as ex:
                served = list(ex.map(ask, jobs))
            served_s = time.perf_counter() - t0
            clip_raw = np.stack([r["body"]["vector"] for r in served[:n_photos]])
            faces_served = dict(zip(disc_idx, (r["body"]["faces"] for r in served[n_photos:])))
            ocr_served = dict(zip(page_idx, (r["body"]["items"] for r in served[n_photos + len(disc_idx):])))
            square_served = [r["body"]["faces"] for r in served[n_photos + len(disc_idx) + len(page_idx):]]
            log(f"phase 11 (a): tier + search up in {boot_s:.2f} s, every service healthy; served answers (tenant "
                f"'served') of the ingest's own pixels as tensor/raw ({n_photos} clip_image_embed, "
                f"{len(disc_idx)} face_detect_and_embed of the disc photos, {len(page_idx)} ocr of the text pages) "
                f"and {len(square)} face_detect_and_embed of phase 9's square photos in {served_s:.2f} s [{card}]")

            # -- (a) the CLI: a cold dense sweep, then captions ---------------------------
            pipes: list = []
            caught: list = []

            class Counted(photo_mod.PhotoIngestPipeline):
                """The CLI's pipeline, zeroing the launch counts once the
                services are built (so the counts are the ingest's own)."""

                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    for k in kernels.values():
                        k.launches = 0
                    pipes.append(self)
                    if on_card:
                        torch.cuda.set_sync_debug_mode("warn")

            real = photo_mod.PhotoIngestPipeline
            photo_mod.PhotoIngestPipeline = Counted
            launches = {}
            pool_before = get_decode_pool().gauges().get("decodes_vlm_canvas", 0)
            try:
                with convolutions_tf32(False), warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    rows_path = work / "index.jsonl"
                    t0 = time.perf_counter()
                    if cli.main(["--config", str(yaml_path), "--input", str(photos_dir), "--output", str(rows_path),
                                 "--families", "clip,face,ocr", "--batch-size", str(batch_size), *platform]):
                        raise AssertionError("phase 11 (a): the CLI's dense sweep exited non-zero")
                    cli_s = time.perf_counter() - t0
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
                    syncs_flagged = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
                    launches["sweep"] = {name: kernels[name].launches for name in PHASE11_KERNELS}
                    # The served captions come from a second server process
                    # (VLM only, booted at the start of the phase), beside the
                    # caption run: its launches are not this process's counts.
                    caps_path = work / "captions.jsonl"
                    vlm_stub = vlm_server.wait()
                    msgs = json.dumps([{"role": "user", "content": CAPTION_PROMPT}])
                    t0 = time.perf_counter()
                    with ThreadPoolExecutor(in_flight) as vex:
                        vlm_futs = [vex.submit(grpc_call, vlm_stub, "vlm_generate", photos[i],
                                               {"messages": msgs, "max_new_tokens": caption_tokens})
                                    for i in range(n_captions)]
                        if cli.main(["--config", str(yaml_path), "--input", str(caps_dir), "--output", str(caps_path),
                                     "--families", "clip,face,ocr,vlm", "--batch-size", str(batch_size),
                                     "--caption-max-tokens", str(caption_tokens), *platform]):
                            raise AssertionError("phase 11 (a): the CLI's caption run exited non-zero")
                        caption_s = time.perf_counter() - t0
                        answers = [f.result() for f in vlm_futs]
                    served_caption_s = time.perf_counter() - t0
                    if any(a["code"] for a in answers):
                        raise AssertionError(f"phase 11 (a): vlm_generate codes {[a['code'] for a in answers]}")
                    captions_served = [a["body"]["text"] for a in answers]
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
                    launches["captions"] = {name: kernels[name].launches for name in PHASE11_KERNELS}
            finally:
                photo_mod.PhotoIngestPipeline = real
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
            vlm_canvas = get_decode_pool().gauges().get("decodes_vlm_canvas", 0) - pool_before
            sweep = pipes[0]
            stats = sweep.stats.as_dict()
            if sweep.decode_max_edge != max_edge:
                raise AssertionError(f"phase 11 (a): the ingest decoded at {sweep.decode_max_edge}, not {max_edge}")
            rows = [json.loads(line) for line in open(rows_path)]
            caps = [json.loads(line) for line in open(caps_path)]
            if len(rows) != n_photos or len(caps) != n_captions or any("error" in r for r in rows + caps):
                raise AssertionError(f"phase 11 (a): {len(rows)} rows, {len(caps)} caption rows, errors "
                                     f"{[r['error'] for r in rows + caps if 'error' in r]}")
            emb = np.stack([np.frombuffer(base64.b64decode(r["clip_embedding"]), "<f4") for r in rows])
            cos_raw = cosines(emb, clip_raw)
            if cos_raw.min() < INGEST_COSINE:
                raise AssertionError(f"phase 11 (a): ingested embeddings vs served, cosine {cos_raw.min():.6f}")
            face_thr = face_mgr.spec.score_threshold
            face_tally = {"matched": 0, "near": 0, "iou_min": 1.0}

            def hold_faces(got: list, want: list, what: str) -> None:
                t = match_near(got, want, face_thr, TF32_SCORE_TOL, what, FACE_IOU,
                               lambda g, w: box_iou(g["bbox"], w["bbox"]),
                               lambda g, w: float(np.dot(g["embedding"], w["embedding"])) >= FACE_COSINE)
                face_tally["matched"] += t["matched"]
                face_tally["near"] += t["near"]
                face_tally["iou_min"] = min(face_tally["iou_min"], t["iou_min"])

            ocr_tally = {"served": 0, "ingested": 0, "matched": 0, "texts_equal": 0}
            counted = {"faces": 0, "ocr_items": 0}  # off the disc photos and the text pages: not held
            for i, (row, (_, dscale, _)) in enumerate(zip(rows, decoded)):
                if i in faces_served:
                    hold_faces([dict(f, bbox=[v * dscale for v in f["bbox"]],
                                     embedding=np.frombuffer(base64.b64decode(f["embedding"]), "<f4"))
                                for f in row.get("faces", [])], faces_served[i], f"phase 11 (a) photo {i} faces")
                else:
                    counted["faces"] += len(row.get("faces", []))
                if i not in ocr_served:
                    counted["ocr_items"] += len(row.get("ocr", []))
                    continue
                # OCR as phase 10 holds its TF32 pass (a contour moves where a
                # pixel near the threshold rounds the other way): one to one at
                # IoU >= OCR_TF32_IOU, counted over the text pages.
                left = list(range(len(ocr_served[i])))
                ocr_tally["served"] += len(left)
                for it in row.get("ocr", []):
                    box = [[x * dscale, y * dscale] for x, y in it["box"]]
                    ious = [ref_quad_iou(box, ocr_served[i][j]["box"]) for j in left]
                    ocr_tally["ingested"] += 1
                    if ious and max(ious) >= OCR_TF32_IOU:
                        j = left.pop(int(np.argmax(ious)))
                        ocr_tally["matched"] += 1
                        ocr_tally["texts_equal"] += int(it["text"] == ocr_served[i][j]["text"])
            sweep_faces = face_tally["matched"]
            # Faces through the pipeline on the server's face manager, on
            # phase 9's square photos (the stand-in's calibration is square:
            # on a 4:3 photo its anchors in the letterbox's flat fill outscore
            # the photo's, and those boxes fall outside the image): the same
            # JPEG bytes the served answers decoded, at the same decode scale.
            t0 = time.perf_counter()
            with convolutions_tf32(False):
                face_pipe = photo_mod.PhotoIngestPipeline(build_mesh(devices=fleet_devices(dev)), face=face_mgr,
                                                          batch_size=min(batch_size, 32))
                for i, rec in enumerate(face_pipe.run(square)):
                    hold_faces([{"bbox": list(f.bbox), "confidence": f.confidence, "embedding": f.embedding}
                                for f in rec.faces], square_served[i], f"phase 11 (a) square photo {i} faces")
            square_s = time.perf_counter() - t0
            share = OCR_TF32_SHARE * ocr_tally["served"]
            if (not face_tally["matched"] or not ocr_tally["served"] or ocr_tally["matched"] < share
                    or ocr_tally["ingested"] - ocr_tally["matched"] > ocr_tally["served"] - share):
                raise AssertionError(f"phase 11 (a): faces {face_tally}, OCR items of the text pages {ocr_tally} "
                                     f"(tol {OCR_TF32_SHARE} of the served items at IoU >= {OCR_TF32_IOU})")
            for i, (row, cap) in enumerate(zip(rows, caps)):
                if cap["caption"] != captions_served[i]:
                    raise AssertionError(f"phase 11 (a): caption {i} {cap['caption']!r} != served "
                                         f"{captions_served[i]!r}")
                if {k: v for k, v in cap.items() if k not in ("caption", "path")} != {
                        k: v for k, v in row.items() if k != "path"}:
                    raise AssertionError(f"phase 11 (a): caption row {i}'s dense part differs from the sweep's")
            if vlm_canvas < n_captions:
                raise AssertionError(f"phase 11 (a): the decode pool counted {vlm_canvas} vlm_canvas decodes")
            missing = [k for k in PHASE11_KERNELS
                       if launches["sweep"][k] + launches["captions"][k] == 0]
            if missing:
                raise AssertionError(f"phase 11 (a): the ingest never launched {missing} ({launches})")
            log(f"phase 11 (a): CLI sweep of {n_photos} {photo_hw[1]}x{photo_hw[0]} JPEGs (clip, face, ocr; "
                f"batch {batch_size}; IEEE convolutions) {stats['items_per_sec']:.2f} images/s ({cli_s:.2f} s with "
                f"the CLI's own boot); stage stats {json.dumps(stats)}; embeddings cosine >= {cos_raw.min():.6f} to "
                f"the served ones; OCR items of the {len(page_idx)} text pages {json.dumps(ocr_tally)} held to the "
                f"served answers; faces: {sweep_faces} matched on the {len(disc_idx)} disc photos, "
                f"{face_tally['matched'] - sweep_faces} on {len(square)} square photos through the pipeline on the "
                f"server's face manager ({square_s:.2f} s), {json.dumps(face_tally)}; counted, not held (the other "
                f"photos): {json.dumps(counted)}; caption run {caption_s:.2f} s (beside {n_captions} vlm_generate of "
                f"a VLM server process, all answered in {served_caption_s:.2f} s): captions equal to the served ones, "
                f"{vlm_canvas} vlm_canvas decodes in the pool; launches {json.dumps(launches)}; syncs "
                f"flagged by the sync debug mode during the sweep {syncs_flagged} "
                f"({syncs_flagged / max(stats['batches'], 1):.1f} a batch), the pipeline's own fetches "
                f"{stats['syncs']} ({stats['syncs'] / max(stats['batches'], 1):.1f} a batch) [{card}]")

            # -- (b) 200k vectors upserted over gRPC ------------------------------------
            rng = np.random.default_rng(seed * 100 + 12)
            vecs = np.empty((n_vectors, dim), np.float32)
            for lo in range(0, n_vectors, chunk):
                vecs[lo:lo + chunk] = normalize(rng.standard_normal((min(chunk, n_vectors - lo), dim), dtype=np.float32))
            ids = [f"vec{i:06d}" for i in range(n_vectors)]
            bundles = [pack_bundle([vecs[lo:lo + chunk], np.frombuffer(json.dumps(ids[lo:lo + chunk]).encode(), np.uint8)])
                       for lo in range(0, n_vectors, chunk)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as ex:
                ups = list(ex.map(ask, [("search_upsert", b, {"priority": "bulk"}, BUNDLE_MIME) for b in bundles]))
            upsert_s = time.perf_counter() - t0
            if sum(r["body"]["added"] for r in ups) != n_vectors:
                raise AssertionError(f"phase 11 (b): {sum(r['body']['added'] for r in ups)} rows added")
            svc = handle.services["search"]
            shards = svc.index.shards_for("default")

            # -- (a) warm re-run on the server's managers, index= into search ------------
            indexed: list = []

            def to_index(sha: str, clip_out: dict) -> str:
                vec = np.asarray(clip_out["embedding"], np.float32)
                ask(("search_upsert", pack_bundle([vec[None], np.frombuffer(json.dumps([sha]).encode(), np.uint8)]),
                     {"priority": "bulk"}, BUNDLE_MIME))
                indexed.append((sha, vec))
                return "indexed"

            warm = photo_mod.PhotoIngestPipeline(
                build_mesh(devices=fleet_devices(dev)), clip=clip_mgr, face=face_mgr, ocr=ocr_mgr,
                batch_size=batch_size, on_decode_error="record", index=to_index)
            for k in kernels.values():
                k.launches = 0
            warm_records = list(warm.run(photos))
            warm_launches = {name: k.launches for name, k in kernels.items()}
            if warm.stats.cache_hit_rate != 1.0 or any(warm_launches.values()) or len(indexed) != n_photos:
                raise AssertionError(f"phase 11 (a): warm re-run hit rate {warm.stats.cache_hit_rate}, launches "
                                     f"{warm_launches}, {len(indexed)} indexed")
            if any(not np.array_equal(r.clip_embedding, e) for r, e in zip(warm_records, emb)):
                raise AssertionError("phase 11 (a): a warm record's embedding differs from the cold row's")
            # Device time of each stage on one full batch (CUDA events), the
            # batch the sweep ran first.
            stage_ms = {}
            if on_card:
                from lumen_tpu_torch.runtime.batcher import stack_and_pad, tree_map

                items = [warm._decode(p) for p in photos[:batch_size]]
                with convolutions_tf32(False):
                    for stage in warm.engine._device_stages:
                        staged = stack_and_pad([stage.preprocess(d) for d in items], batch_size)
                        batch = tree_map(lambda a: torch.from_numpy(a).to(dev), staged)
                        # the stage's callable on the pipeline's one data place
                        fn = warm.engine._place_fns[stage.name][0]
                        stage_ms[stage.name] = cuda_ms(lambda f=fn, b=batch: f(b), iters=5, warmup=2)
            log(f"phase 11 (a): warm re-run on the server's managers: {warm.stats.as_dict()['items']} items, hit rate "
                f"{warm.stats.cache_hit_rate:.4f}, launches {json.dumps(warm_launches)}, index= fired {len(indexed)} "
                f"times (search_upsert over gRPC); device ms a {batch_size}-image batch "
                f"{json.dumps({k: round(v, 3) for k, v in stage_ms.items()})} [{card}]")

            # -- (b) 512 queries against the numpy oracle ---------------------------------
            photo_ids = [sha for sha, _ in indexed]
            photo_vecs = normalize(np.stack([v for _, v in indexed]))
            corpus = np.concatenate([vecs, photo_vecs])
            corpus_ids = ids + photo_ids
            queries = np.concatenate([
                normalize(rng.standard_normal((n_queries - n_photos, dim), dtype=np.float32)),
                np.stack([v for _, v in indexed]),
            ])
            t0 = time.perf_counter()
            scores = normalize(queries) @ corpus.T  # a row a query
            for j in range(2):  # the column oracle is exact_oracle's answer
                sub = slice(0, min(20_000, len(corpus)))
                want = exact_oracle(corpus_ids[sub], corpus[sub], queries[j], 10)
                got = oracle_topk(corpus[sub] @ normalize(queries[j])[0], corpus_ids[sub], 10)
                if got[0] != want[0]:
                    raise AssertionError("phase 11 (b): the column oracle differs from exact_oracle")
            oracle_s = time.perf_counter() - t0
            qjobs = [("search_query", *raw(q), TENSOR_MIME) for q in queries]
            for job in qjobs:
                job[2]["k"] = "10"
            before = {key: dict(b.stats) for key, b in svc._batchers.items()}
            t0 = time.perf_counter()
            with ThreadPoolExecutor(in_flight) as ex:
                answers = list(ex.map(ask, qjobs))
            query_s = time.perf_counter() - t0
            passes = {stat: sum(b.stats[stat] - before.get(key, {}).get(stat, 0) for key, b in svc._batchers.items())
                      for stat in ("items", "batches")}
            solo = np.sort([ask(job)["s"] * 1e3 for job in qjobs[:32]])  # one in flight
            near, worst = 0, 0.0
            for j, r in enumerate(answers):
                want_ids, want_scores, gap = oracle_topk(scores[j], corpus_ids, 10)
                got_ids, got_scores = r["body"]["ids"], r["body"]["scores"]
                worst = max(worst, float(np.abs(np.asarray(got_scores) - want_scores).max()))
                if gap < SEARCH_SCORE_TOL:
                    near += 1
                elif set(got_ids) != set(want_ids):
                    raise AssertionError(f"phase 11 (b): query {j} recall@10 {len(set(got_ids) & set(want_ids)) / 10}")
                if worst > SEARCH_SCORE_TOL:
                    raise AssertionError(f"phase 11 (b): query {j}'s scores differ from the oracle's by {worst:.2e}")
            self_rank1 = [answers[n_queries - n_photos + i]["body"]["ids"][0] == photo_ids[i] for i in range(n_photos)]
            if not all(self_rank1):
                raise AssertionError(f"phase 11 (b): {self_rank1.count(False)} ingested photos not at rank 1 of their "
                                     "own embedding")
            margin = min(answers[n_queries - n_photos + i]["body"]["scores"][0]
                         - answers[n_queries - n_photos + i]["body"]["scores"][1] for i in range(n_photos))
            lat = np.sort([r["s"] * 1e3 for r in answers])
            pct = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))])  # noqa: E731

            # -- (b) queries during a bulk-upsert flood (one pinned shard) -----------------
            frng = np.random.default_rng(seed * 100 + 13)
            base = normalize(frng.standard_normal((40, dim), dtype=np.float32))
            fids = [f"f{i:03d}" for i in range(40)]
            versions = {vid: [v] for vid, v in zip(fids, base)}
            flood = {"tenant": "flood", "shard": "0", "priority": "bulk"}
            ask(("search_upsert", pack_bundle([base, np.frombuffer(json.dumps(fids).encode(), np.uint8)]), flood,
                 BUNDLE_MIME))
            fq = normalize(frng.standard_normal(dim, dtype=np.float32))[0]
            lock, done = threading.Lock(), threading.Event()
            steps = 10

            def writer():
                try:
                    for step in range(steps):
                        new = [f"n{step:02d}-{j}" for j in range(8)]
                        upd = [fids[(step * 8 + j) % 40] for j in range(8)]
                        vs = normalize(frng.standard_normal((16, dim), dtype=np.float32))
                        with lock:  # recorded before the upsert is sent
                            for vid, v in zip(new + upd, vs):
                                versions.setdefault(vid, []).append(v)
                        ask(("search_upsert", pack_bundle([vs, np.frombuffer(json.dumps(new + upd).encode(), np.uint8)]),
                             flood, BUNDLE_MIME))
                        time.sleep(0.01)
                finally:
                    done.set()

            def reader(_):
                seen = []
                payload, meta = raw(fq)
                while not done.is_set():
                    seen.append(ask(("search_query", payload, {**meta, "tenant": "flood", "shard": "0", "k": "128"},
                                     TENSOR_MIME))["body"])
                return seen

            t0 = time.perf_counter()
            with ThreadPoolExecutor(in_flight + 1) as ex:
                wfut = ex.submit(writer)
                seen = [b for part in ex.map(reader, range(in_flight)) for b in part]
                wfut.result()
            flood_s = time.perf_counter() - t0
            counts = sorted({len(b["ids"]) for b in seen})
            if not set(counts) <= {40 + 8 * j for j in range(steps + 1)} or len(counts) < 2:
                raise AssertionError(f"phase 11 (b): answer counts during the flood {counts}")
            for b in seen:
                for vid, s in zip(b["ids"], b["scores"]):
                    if not any(abs(float(v @ fq) - s) <= SEARCH_SCORE_TOL for v in versions.get(vid, [])):
                        raise AssertionError(f"phase 11 (b): {vid} at {s:.6f} matches no committed version")

            # -- (b) one scoring pass over the fullest shard ------------------------------
            full = max(shards.values(), key=lambda s: s.count)
            with full._lock:
                buf, n = full._buf, full._n
            pass_ms = bound_ms = None
            if on_card:
                qd = torch.from_numpy(normalize(queries[:in_flight])).to(dev)
                pass_ms = cuda_ms(lambda: _score_topk(buf, qd, n, 128, ann_tile()), iters=20)
                bound_ms = max(n * dim * 4 / HBM_BYTES_PER_S, 2 * in_flight * n * dim / FP32_FLOPS) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
            log(f"phase 11 (b): {n_vectors:,} unit vectors at dim {dim} upserted over gRPC in {len(bundles)} "
                f"{chunk}-row search_upsert calls (4 at once) in {upsert_s:.2f} s = {n_vectors / upsert_s:,.0f} rows/s, "
                f"{len(shards)} shards of {sorted(s.count for s in shards.values())} rows (capacity "
                f"{sorted(s.capacity for s in shards.values())}); {n_queries} search_query at k = 10, {in_flight} in "
                f"flight, in {query_s:.2f} s: p50 {pct(0.5):.2f} ms, p95 {pct(0.95):.2f} ms ({passes['items']} shard "
                f"queries in {passes['batches']} scoring passes; alone, p50 {float(solo[len(solo) // 2]):.2f} ms); "
                f"recall@10 = 1.0 against "
                f"the oracle ({oracle_s:.1f} s on the host) on every query but {near} near-ties (10th and 11th "
                f"within {SEARCH_SCORE_TOL}), scores within {worst:.2e}; {n_photos} photos at rank 1 of their own "
                f"embedding (margin >= {margin:.6f}); during a flood of {steps} bulk upserts (8 appends + 8 updates "
                f"in place each) {len(seen)} queries saw counts {counts}, every id committed, every score one of its "
                f"row's versions ({flood_s:.2f} s); one scoring pass over a {n}-row shard at {in_flight} queries "
                f"{'not measured' if pass_ms is None else f'{pass_ms:.4f} ms'}"
                f"{'' if bound_ms is None else f' (bound {bound_ms:.4f} ms, bytes vs fp32 FLOPs)'}; peak memory "
                f"{peak:.3f} GiB [{card}]")
            out.update(boot_s=boot_s, images_s=stats["items_per_sec"], stats=stats, launches=launches,
                       warm_launches=warm_launches, cos_min=float(cos_raw.min()), faces=face_tally, ocr=ocr_tally,
                       stage_ms=stage_ms, syncs_flagged=syncs_flagged, upsert_rows_s=n_vectors / upsert_s,
                       p50_ms=pct(0.5), p95_ms=pct(0.95), solo_p50_ms=float(solo[len(solo) // 2]),
                       mean_pass=passes["items"] / max(passes["batches"], 1), near_ties=near, score_err=worst, pass_ms=pass_ms,
                       pass_bound_ms=bound_ms, flood_queries=len(seen), flood_counts=counts, peak_gib=peak)
        finally:
            channel.close()
            handle.stop(grace=1.0)
            vlm_server.stop()
    shutdown_decode_pool()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 12: every VLM and CLIP serving option ------------------------------------

#: the kernels phase 12 requires: (a) the graph-tower captions on the
#: continuous engine, (c) the coalescer's prefill, and its int8 decode
PHASE12_GRAPH_KERNELS = ("flash_attention_cache", "paged_attention")
PHASE12_COALESCE_KERNELS = ("flash_attention_cache",)
PHASE12_COALESCE_INT8_KERNELS = ("flash_attention_cache", "w8a16_matmul")
#: (d): the W8A8 CLIP towers launch the flash kernel in every block
PHASE12_CLIP_KERNELS = ("flash_attention",)
#: (a): the graph tower on the card (IEEE float32) against the stand-in
#: module's float32 forward on the same pixels: |diff| <= this x max |want|
GRAPH_TOWER_TOL = 1e-4
#: (d): W8A8 CLIP embeddings against the bf16 ones (the JAX suite's int8
#: bound, ``tests/test_clip_quant.py``)
Q8_CLIP_COSINE = 0.98
#: (b): the A/B's device memory above its start may pass the bf16
#: decoder's bytes by this much (KV pool, activations, logits), which is
#: short of the int8 decoder's bytes: two decoder sets at once fail
AB_MEMORY_MARGIN = 256 * 2**20
#: (c): a prompt of the 128 bucket (the short one takes the 64 bucket)
LONG_PROMPT = ("describe this photo in one detailed sentence : " + "a red car on a wet road , " * 12).strip()


def write_fastvlm_dir(root: Path, src: Path, name: str, tower_cfg, seed: int) -> tuple[Path, float]:
    """A FastVLM-style model directory from phase 6's: the checkpoint
    without its vision tower (decoder only, HF names), phase 6's
    ``config.json``, tokenizer and chat template, and the FastViTHD
    stand-in exported as ``onnx/vision_encoder.onnx`` at the canvas size;
    returns it and the export's seconds."""
    import torch
    from safetensors.torch import load_file, save_file

    from lumen_tpu_torch.testing.fastvlm_standins import fastvithd_standin
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    model_dir = root / "models" / name
    (model_dir / "onnx").mkdir(parents=True)
    state = load_file(str(src / "model.safetensors"))
    save_file({k: v for k, v in state.items() if not k.startswith(("vision_tower.", "multi_modal_projector."))},
              str(model_dir / "model.safetensors"))
    del state
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        shutil.copy(src / f, model_dir / f)
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "FastVLM-shaped: decoder weights + an exported vision tower",
        "model_type": "vlm", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors", "onnx/vision_encoder.onnx"]}},
    }))
    t0 = time.perf_counter()
    tower = fastvithd_standin(seed, tower_cfg)
    size = tower_cfg.image_size
    with torch.no_grad():
        export_onnx(tower, (torch.zeros(1, 3, size, size),), str(model_dir / "onnx" / "vision_encoder.onnx"),
                    input_names=["pixel_values"], dynamic_axes={"pixel_values": {0: "b"}})
    return model_dir, time.perf_counter() - t0


def drive_vlm_options(seed: int, card: str, root: Path, phase6: dict, phase8: dict, device: str = "cuda:0",
                      tower_cfg=None, n_captions: int = 8, n_streams: int = 2, tokens: int = 24,
                      clip_batch: int = 64, ab_boots: int = 2) -> dict:
    """Phase 12: the VLM and CLIP options of the JAX managers. (a) a
    FastVLM-style directory (phase 6's decoder, the FastViTHD stand-in as
    ``onnx/vision_encoder.onnx``, no native tower) served by ``serve()``
    from a YAML in ``generate_config``'s shape; (b) the VLM int8 route's
    warm-up A/B and its verdict file; (c) ``scheduler: coalesce`` in bf16
    and int8 on phase 6's directory; (d) CLIP ``quantize: int8`` (W8A8) on
    phase 8's directory. ``tower_cfg``/``device`` and the counts let the
    CPU tests rehearse it small; its launch-count gates then fail unless
    emptied."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.models.vlm import modeling as vlm_modeling
    from lumen_tpu_torch.runtime.decode_pool import shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.testing.fastvlm_standins import FastViTHDConfig, fastvithd_standin
    from lumen_tpu_torch.utils.host_decode import vlm_canvas
    from lumen_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    kernels = {k.name: k for k in all_kernels()}
    cfg = vlm_config_of(phase6["model_dir"])
    tower_cfg = tower_cfg or FastViTHDConfig(hidden_size=cfg.decoder.hidden_size, image_size=cfg.vision.image_size)
    photos, prompt = phase6["photos"], phase6["prompt"]
    question = json.loads(prompt)[0]["content"]
    n = n_captions + n_streams
    out: dict = {"launches": {}}

    def reset_launches():
        for k in kernels.values():
            k.launches = 0

    def launched(names) -> dict:
        return {name: kernels[name].launches for name in names}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- (a) FastVLM-0.5B's shape: the exported vision tower on the bridge ----------
    fast_dir, export_s = write_fastvlm_dir(root / "cache", Path(phase6["model_dir"]), "SmokeFastVLM", tower_cfg, seed + 12)
    onnx_mb = (fast_dir / "onnx" / "vision_encoder.onnx").stat().st_size / 2**20
    log(f"phase 12 (a): FastViTHD stand-in (layers {list(tower_cfg.layers)}, widths {list(tower_cfg.embed_dims)}, "
        f"expansion {tower_cfg.out_width}, projector -> {tower_cfg.hidden_size}) exported at {tower_cfg.image_size} px in "
        f"{export_s:.1f} s ({onnx_mb:.0f} MiB); the directory holds no native vision weights")
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    vlm_settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [64, 128, 256, 512, 1024]}
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(n + 8)):
        handle, channel, stub, load_s = boot_server(
            ocr_yaml(root / "fastvlm.yaml", root / "cache", {"vlm": ("SmokeFastVLM", vlm_settings)}), device)
    try:
        mgr = handle.services["vlm"].manager
        if mgr._vision_graph is None or mgr.vision_tokens != tower_cfg.num_tokens:
            raise AssertionError(f"phase 12 (a): the vlm service serves no graph tower ({mgr.vision_tokens} tokens)")
        reset_launches()
        metas = [{"messages": prompt, "max_new_tokens": tokens}] * n
        tasks = ["vlm_generate"] * n_captions + ["vlm_generate_stream"] * n_streams
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as ex:
            res = list(ex.map(lambda i: grpc_call(stub, tasks[i], photos[i], metas[i]), range(n)))
        wall = time.perf_counter() - t0
        drive_peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2**20 if on_card else 0.0
        graph_launches = launched(kernels)
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 12 (a): codes {[r['code'] for r in res]}")
        missing = [k for k in PHASE12_GRAPH_KERNELS if graph_launches[k] == 0]
        if missing:
            raise AssertionError(f"phase 12 (a): never launched {missing} ({graph_launches})")
        msgs = [ChatMessage("user", question)]
        for i, r in enumerate(res):
            if i < n_captions:
                alone = mgr._generate_uncached(msgs, None, tokens, 0.0, 1.0, False, 1.0, None, True, photos[i])
                same = (alone.text, len(alone.tokens)) == (r["body"]["text"], r["body"]["generated_tokens"])
            else:
                text = "".join(c.text for c in mgr.generate_stream(msgs, image_bytes=photos[i], max_new_tokens=tokens))
                same = text == b"".join(r["deltas"]).decode() == r["body"]["text"]
            if not same:
                raise AssertionError(f"phase 12 (a): request {i} ({tasks[i]}) differs from the manager's rerun alone")
        ttfts = sorted(r["ttft_ms"] for r in res[n_captions:])
        lat = sorted(r["s"] * 1e3 for r in res[:n_captions])
        # the graph tower against the stand-in module, IEEE float32 on both sides
        canvas = torch.from_numpy(vlm_canvas(photos[0], cfg.vision.image_size)).to(mgr.device)
        x = ((canvas[None].float() / 255.0 - mgr._mean) / mgr._std).permute(0, 3, 1, 2).contiguous()
        tower = fastvithd_standin(seed + 12, tower_cfg).to(mgr.device)
        with convolutions_tf32(False), torch.no_grad():
            got = mgr._vision_graph(mgr._vision_params, x).float()
            want = tower(x).float()
        del tower
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not torch.isfinite(got).all() or err > GRAPH_TOWER_TOL * scale:
            raise AssertionError(f"phase 12 (a): graph tower vs the stand-in module: max|diff| {err:.3e} "
                                 f"(scale {scale:.3e})")
        ids = torch.full((1, 64), cfg.pad_token_id, device=mgr.device)
        ids[0, 0] = cfg.image_token_id
        length = torch.tensor([20], device=mgr.device)
        prepare_syncs = count_syncs(lambda: mgr._prepare(canvas[None], ids, length)) if on_card else 0
        if prepare_syncs:
            raise AssertionError(f"phase 12 (a): _prepare made {prepare_syncs} device-to-host syncs")
        tower_ms = cuda_ms(lambda: mgr._vision_graph(mgr._vision_params, x), 5, warmup=1) if on_card else 0.0
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            mgr._vision_graph(mgr._vision_params, x)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        tower_wall_ms = min(walls)
        n_nodes = len(mgr._vision_graph.module.graph.nodes)
    finally:
        channel.close()
        handle.stop(grace=1.0)
    vision_tokens = mgr.vision_tokens
    del mgr, handle  # (b) measures device memory: (a)'s weights go first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["launches"]["(a)"] = graph_launches
    log(f"phase 12 (a): vlm service up in {load_s:.2f} s with the graph tower ({n_nodes} nodes, "
        f"{vision_tokens} tokens); {n_captions} vlm_generate + {n_streams} streams of 1600x1200 JPEGs at once in "
        f"{wall:.3f} s, each equal to the manager's rerun alone; stream ttft_ms {[round(t, 1) for t in ttfts]} "
        f"(p50 {ttfts[len(ttfts) // 2]:.1f}), caption latency p50 {lat[len(lat) // 2]:.0f} ms; graph tower "
        f"{tower_ms:.2f} ms a 1-image forward (CUDA events, TF32 convolutions; {tower_wall_ms:.2f} ms of host wall, "
        f"synchronized, on an idle server) and IEEE max|diff| {err:.3e} vs the "
        f"stand-in module (scale {scale:.3e}); _prepare syncs {prepare_syncs}; device memory {mem0 / 2**30:.3f} GiB at the "
        f"drive's start, peak {drive_peak_mib:.1f} MiB above it; launches {json.dumps(graph_launches)} [{card}]")
    out.update(export_s=export_s, fast_load_s=load_s, tower_ms=tower_ms, tower_wall_ms=tower_wall_ms,
               ttft_p50_ms=ttfts[len(ttfts) // 2], drive_peak_mib=drive_peak_mib,
               prepare_syncs=prepare_syncs, tower_err=err, tower_nodes=n_nodes)

    # -- (b) the VLM int8 route: warm-up A/Bs, verdict file, a boot that reads it ------
    # The first ``ab_boots`` boots each time the A/B (the verdict file is
    # removed between them: the spread of its ratio between boots); the
    # last one reads the file.
    src_dir = Path(phase6["model_dir"])
    verdict_path = src_dir / ".lumen_q8_verdict.json"
    rates: list = []
    ab_mem: list = []
    real_time, real_ab = VLMManager._time_decode_route, VLMManager._q8_decode_ab

    def timed(self, route_cfg, state):
        rate = real_time(self, route_cfg, state)
        rates.append((route_cfg.decoder.weight_quant or "bf16", rate))
        return rate

    def measured_ab(self, base_cfg, q_cfg, cast, qstate):
        decoder_bytes = [sum(t.numel() * t.element_size() for k, t in st.items() if not k.startswith("vision."))
                         for st in (cast, qstate)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        try:
            return real_ab(self, base_cfg, q_cfg, cast, qstate)
        finally:
            peak = torch.cuda.max_memory_allocated() - base if on_card else 0
            ab_mem.append(dict(peak=peak, bf16=decoder_bytes[0], int8=decoder_bytes[1]))

    VLMManager._time_decode_route, VLMManager._q8_decode_ab = timed, measured_ab
    boots = []
    try:
        for attempt in range(ab_boots + 1):
            if 0 < attempt < ab_boots:
                verdict_path.unlink()
            reset_result_cache()
            if on_card:
                torch.cuda.empty_cache()
            with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_Q8_ROUTE="auto"):
                handle, channel, stub, boot_s = boot_server(deployment_yaml(
                    root / "q8auto.yaml", root / "cache", "SmokeVLM", "int8", extra={"warmup": True}), device)
            try:
                mgr = handle.services["vlm"].manager
                verdict = json.loads(verdict_path.read_text())
                gauges = metrics.snapshot()["gauges"].get(f"vlm-quant:{mgr.model_id}")
                cap_route = handle.services["vlm"].capability().extra["quant_route"]
                reset_launches()
                r = grpc_call(stub, "vlm_generate", photos[0], {"messages": prompt, "max_new_tokens": 8})
                boots.append(dict(boot_s=boot_s, route=mgr.quant_route, speedup=mgr.quant_speedup, verdict=verdict,
                                  gauges=gauges, cap_route=cap_route, code=r["code"],
                                  w8a16=kernels["w8a16_matmul"].launches))
            finally:
                channel.close()
                handle.stop(grace=1.0)
            del mgr, handle
    finally:
        VLMManager._time_decode_route, VLMManager._q8_decode_ab = real_time, real_ab
    first, again, reader = boots[0], boots[ab_boots - 1], boots[-1]
    if [q for q, _ in rates] != ["bf16", "int8"] * ab_boots:
        raise AssertionError(f"phase 12 (b): the A/B boots timed {rates}; the verdict boot must not")
    for b in boots:
        want_gauges = {"int8_active": int(b["verdict"]["route"] == "int8"),
                       "q8_speedup_pct": round(b["verdict"]["q8_speedup"] * 100, 1)}
        if b["route"] != b["verdict"]["route"] or b["cap_route"] != b["route"] or b["gauges"] != want_gauges \
                or b["code"] or (on_card and (b["route"] == "int8") != (b["w8a16"] > 0)):
            raise AssertionError(f"phase 12 (b): a boot's route, verdict and gauges disagree: {b}")
    if reader["verdict"] != again["verdict"]:
        raise AssertionError("phase 12 (b): the verdict boot rewrote the verdict file")
    # The A/B holds one decoder set at a time: its peak above what the
    # device held before it stays under the bf16 decoder plus a working
    # margin, well short of both sets together.
    for m in ab_mem:
        if on_card and not m["peak"] <= m["bf16"] + AB_MEMORY_MARGIN < m["bf16"] + m["int8"]:
            raise AssertionError(f"phase 12 (b): the A/B's peak {m['peak']} B above its start exceeds the bf16 "
                                 f"decoder ({m['bf16']} B) + {AB_MEMORY_MARGIN} B (int8 decoder {m['int8']} B)")
    bf16_tps, q8_tps = [r for _, r in rates[0::2]], [r for _, r in rates[1::2]]
    ratios = [q / b for b, q in zip(bf16_tps, q8_tps)]
    log(f"phase 12 (b): LUMEN_VLM_Q8_ROUTE=auto, warmup, scheduler continuous: A/B decode (the engine's step_block, "
        f"batch 4, 64 tokens a row; best of 2), a boot each: "
        + "; ".join(f"{b:.1f} tok/s bf16 vs {q:.1f} int8 -> {boot['route']} ({q / b:.3f}x)"
                    for b, q, boot in zip(bf16_tps, q8_tps, boots))
        + f"; device memory above the A/B's start, peak "
        f"{[round(m['peak'] / 2**20, 1) for m in ab_mem]} MiB (bf16 decoder {ab_mem[0]['bf16'] / 2**20:.1f} MiB, "
        f"int8 {ab_mem[0]['int8'] / 2**20:.1f} MiB); verdict {json.dumps(again['verdict'])}; boots "
        f"{' / '.join(format(b['boot_s'], '.2f') for b in boots[:-1])} s (A/B) then {reader['boot_s']:.2f} s (verdict read, "
        f"no probe); served route {reader['route']}, gauges {json.dumps(reader['gauges'])}, w8a16 launches "
        f"{reader['w8a16']} [{card}]")
    out.update(ab_bf16_tps=bf16_tps, ab_q8_tps=q8_tps, ab_ratios=ratios,
               ab_route=first["route"], ab_peak_mib=[m["peak"] / 2**20 for m in ab_mem],
               boot_ab_s=[b["boot_s"] for b in boots[:-1]], boot_verdict_s=reader["boot_s"])

    # -- (c) scheduler: coalesce, bf16 then int8 ------------------------------------
    questions = [question if i % 2 == 0 else LONG_PROMPT for i in range(n)]
    for quantize in (None, "int8"):
        tag = quantize or "bf16"
        reset_result_cache()
        if on_card:
            torch.cuda.empty_cache()
        with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_Q8_ROUTE="int8", LUMEN_GRPC_WORKERS=str(n + 8)):
            handle, channel, stub, boot_s = boot_server(deployment_yaml(
                root / f"coalesce-{tag}.yaml", root / "cache", "SmokeVLM", quantize,
                extra={"scheduler": "coalesce"}), device)
        try:
            mgr = handle.services["vlm"].manager
            if mgr.scheduler != "coalesce" or mgr.quant_route != tag:
                raise AssertionError(f"phase 12 (c): serving {mgr.scheduler} / {mgr.quant_route}")
            reset_launches()
            batches0 = mgr._batcher.batches_run
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n) as ex:
                res = list(ex.map(lambda i: grpc_call(
                    stub, tasks[i], photos[i], {"messages": json.dumps([{"role": "user", "content": questions[i]}]),
                                                "max_new_tokens": tokens}), range(n)))
            wall = time.perf_counter() - t0
            co_launches = launched(kernels)
            batches = mgr._batcher.batches_run - batches0
            if any(r["code"] for r in res):
                raise AssertionError(f"phase 12 (c) {tag}: codes {[r['code'] for r in res]}")
            need = PHASE12_COALESCE_INT8_KERNELS if quantize else PHASE12_COALESCE_KERNELS
            missing = [k for k in need if co_launches[k] == 0]
            if missing:
                raise AssertionError(f"phase 12 (c) {tag}: never launched {missing} ({co_launches})")
            differ = []
            for i, r in enumerate(res):
                msgs = [ChatMessage("user", questions[i])]
                if i < n_captions:
                    alone = mgr._generate_uncached(msgs, None, tokens, 0.0, 1.0, False, 1.0, None, True, photos[i])
                    if (alone.text, len(alone.tokens)) != (r["body"]["text"], r["body"]["generated_tokens"]):
                        differ.append(i)
                else:
                    text = "".join(c.text for c in mgr.generate_stream(msgs, image_bytes=photos[i],
                                                                       max_new_tokens=tokens))
                    if text != b"".join(r["deltas"]).decode():
                        differ.append(i)
            if differ:
                raise AssertionError(f"phase 12 (c) {tag}: requests {differ} differ from their rerun alone")
            # device-to-host syncs a decode step: two fused decodes of 8 and
            # 24 tokens over the same prompts, and the old per-layer ladder
            # read (the decode step without the host's bound) for comparison
            prepared = [mgr._make_gen_request([ChatMessage("user", question)], None, tokens, 0.0, 1.0, False,
                                              1.0, True, photos[i])[0] for i in range(min(4, n))]
            rows = dict(embeds=torch.cat([p.embeds for p in prepared]),
                        positions=torch.cat([p.positions for p in prepared]),
                        lengths=np.asarray([p.n_prompt for p in prepared]),
                        prompt_ids=torch.cat([p.prompt_ids for p in prepared]))
            gen = mgr.generator

            def decode(steps):
                o = gen.generate(rows["embeds"], rows["positions"], rows["lengths"], rows["prompt_ids"],
                                 torch.Generator(device=mgr.device), max_new_tokens=steps)
                return int(o.n_generated.max())

            def per_step() -> float:
                if not on_card:
                    decode(2)  # the path runs; the CPU counts no device syncs
                    return 0.0
                s8, s24 = count_syncs(lambda: decode(8)), count_syncs(lambda: decode(24))
                return (s24 - s8) / max(decode(24) - decode(8), 1)

            syncs = per_step()
            real_cached = vlm_modeling.attention_cached

            def ladder_read(*args, kv_bound=None, **kw):
                return real_cached(*args, **kw)

            vlm_modeling.attention_cached = ladder_read
            try:
                syncs_old = per_step()
            finally:
                vlm_modeling.attention_cached = real_cached
            if syncs > 1:
                raise AssertionError(f"phase 12 (c) {tag}: {syncs} device-to-host syncs a decode step")
            tok = sum(r["body"]["generated_tokens"] for r in res)
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out["launches"][f"(c) {tag}"] = co_launches
        log(f"phase 12 (c) scheduler: coalesce, {tag}: up in {boot_s:.2f} s; {n_captions} vlm_generate + {n_streams} "
            f"streams over the 64 and 128 prompt buckets at once, {tok} tokens in {wall:.3f} s ({tok / wall:.1f} tok/s) in "
            f"{batches} batches, each answer equal to its rerun alone; device-to-host syncs a decode step {syncs:.2f} "
            f"(the per-layer ladder read: {syncs_old:.2f}); launches {json.dumps(co_launches)} [{card}]")
        out[f"coalesce_{tag}"] = dict(tok_s=tok / wall, syncs=syncs, syncs_old=syncs_old, batches=batches)

    # -- (d) CLIP ViT-B/32 quantize: int8 (W8A8) at batch 64 --------------------------
    clip_dir = str(root / "cache" / "models" / "SmokeCLIP")
    times: list = []
    real_clip_time = CLIPManager._time_image_encode

    def clip_timed(self, models):  # one copy a data place
        t = real_clip_time(self, models)
        times.append(t)
        return t

    CLIPManager._time_image_encode = clip_timed
    try:
        reset_result_cache()
        with env(LUMEN_CLIP_Q8_ROUTE="auto"):
            t0 = time.perf_counter()
            auto = CLIPManager(clip_dir, dataset="Smoke1k", dtype="bfloat16", batch_size=clip_batch, warmup=True,
                               quantize="int8", device=device)
            auto.initialize()
            auto_s = time.perf_counter() - t0
        try:
            auto_route, auto_speedup = auto.quant_route, auto.quant_speedup
            auto_gauges = metrics.snapshot()["gauges"][f"clip-quant:{auto.model_id}"]
        finally:
            auto.close()
    finally:
        CLIPManager._time_image_encode = real_clip_time
    if len(times) != 2 or auto_gauges != {"int8_active": int(auto_route == "int8"),
                                          "q8_speedup_pct": round(auto_speedup * 100, 1)}:
        raise AssertionError(f"phase 12 (d): the A/B timed {times}, gauges {auto_gauges}")
    n_ref = min(len(phase8["photos"]), clip_batch)
    ref_vecs = np.asarray(phase8["vecs"][:n_ref])
    clip_photos = list(phase8["photos"][:n_ref])
    if clip_batch > n_ref:
        clip_photos += photo_batch(seed * 100 + 12, clip_batch - n_ref)
    reset_result_cache()
    with env(LUMEN_CLIP_Q8_ROUTE="int8"):
        t0 = time.perf_counter()
        q8 = CLIPManager(clip_dir, dataset="Smoke1k", dtype="bfloat16", batch_size=clip_batch, quantize="int8",
                         device=device)
        q8.initialize()
        q8_s = time.perf_counter() - t0
    try:
        if q8.quant_route != "int8" or metrics.snapshot()["gauges"][f"clip-quant:{q8.model_id}"]["int8_active"] != 1:
            raise AssertionError("phase 12 (d): the pinned int8 boot does not serve int8")
        reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(clip_photos)) as ex:
            vecs = np.stack(list(ex.map(q8.encode_image, clip_photos)))
        clip_wall = time.perf_counter() - t0
        clip_launches = launched(PHASE12_CLIP_KERNELS)
    finally:
        q8.close()
    missing = [k for k, v in clip_launches.items() if v == 0]
    cos = cosines(vecs[: len(ref_vecs)], ref_vecs)
    if missing or not np.isfinite(vecs).all() or cos.min() < Q8_CLIP_COSINE:
        raise AssertionError(f"phase 12 (d): launches {clip_launches}, W8A8 vs bf16 cosine min {cos.min():.6f}")
    out["launches"]["(d)"] = clip_launches
    log(f"phase 12 (d): CLIP quantize: int8 (W8A8, torch._int_mm), LUMEN_CLIP_Q8_ROUTE=auto with warmup: a batch of "
        f"{clip_batch} in {times[0] * 1e3:.3f} ms bf16 vs {times[1] * 1e3:.3f} ms int8 ({clip_batch / times[0]:.0f} vs "
        f"{clip_batch / times[1]:.0f} images/s, best of 3) -> {auto_route} ({auto_speedup:.3f}x), boot {auto_s:.2f} s; "
        f"a pinned int8 boot ({q8_s:.2f} s) embeds {len(clip_photos)} photos in {clip_wall:.3f} s, W8A8 vs phase 8's "
        f"bf16 cosine min {cos.min():.6f} (bound {Q8_CLIP_COSINE}) over {len(ref_vecs)}; launches "
        f"{json.dumps(clip_launches)} [{card}]")
    shutdown_decode_pool()
    out.update(clip_bf16_ms=times[0] * 1e3, clip_q8_ms=times[1] * 1e3, clip_route=auto_route, clip_cos=float(cos.min()),
               phase_s=time.perf_counter() - t_phase)
    return out


# -- phase 13: a disaggregated fleet on one card ----------------------------------

#: the kernels the decode host must launch for migrated rows, and the one it
#: must never launch for them (it prefills nothing)
PHASE13_DECODE_KERNELS = ("paged_attention",)
PHASE13_NO_PREFILL = ("flash_attention_cache",)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fleet_yaml(path: Path, cache_dir: Path, model: str, port: int, enabled: bool = True) -> Path:
    """Phase 6's bf16 deployment (8 slots, page size 16) on ``port``; with
    ``enabled`` false the same file boots a front tier (no service)."""
    import yaml

    deployment_yaml(path, cache_dir, model, None)
    spec = yaml.safe_load(path.read_text())
    spec["server"]["port"] = port
    spec["services"]["vlm"]["enabled"] = enabled
    path.write_text(yaml.safe_dump(spec))
    return path


def serve_host(argv: list[str]) -> int:
    """The port's server CLI with a readout (``chip_smoke.py --serve-host``
    and the CLI's own arguments): ``lumen_tpu_torch.serving.server.main``,
    whose hook zeroes every kernel's launch count and the peak-memory mark
    once the server answers and prints ``{"serving": port, "metrics_port":
    ...}``; after SIGTERM and the drain, the last line is ``{"launches":
    ..., "peak_gib": ..., "cuda_initialized": ...}``: what the host did
    while it served."""
    import torch

    from lumen_tpu_torch.serving import server

    kernels = all_kernels()

    def serving(handle) -> None:
        for k in kernels:
            k.launches = 0
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
        sidecar = handle.metrics_server
        print(json.dumps({"serving": handle.port, "metrics_port": sidecar.port if sidecar else None}), flush=True)

    rc = server.main(argv, on_serving=serving)
    cuda = torch.cuda.is_initialized()
    print(json.dumps({"launches": {k.name: k.launches for k in kernels}, "cuda_initialized": cuda,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}), flush=True)
    return rc


#: the keys of a ``--serve-host`` process's last line
READOUT_KEYS = frozenset({"launches", "cuda_initialized", "peak_gib"})


class ServerProcess:
    """The port's server CLI in a process of its own on ``port``, started at
    construction: ``python -m lumen_tpu_torch.serving.server``, or with
    ``readout`` the same CLI under ``chip_smoke.py --serve-host`` (with its
    metrics sidecar), which reports the launches and peak memory it had
    while it served. :meth:`wait` gives a stub once the server answers;
    :meth:`stop` sends SIGTERM (a graceful drain) and raises unless the
    process exits 0 within its time (and, with ``readout``, printed its
    readout); a process that does not end is killed first."""

    def __init__(self, name: str, yaml_path: Path, port: int, device: str, log_path: Path, extra_env: dict,
                 readout: bool = False):
        import queue

        self.name, self.port, self.log_path, self.readout = name, port, log_path, readout
        self.log = open(log_path, "w")
        cli = ["--config", str(yaml_path), "--skip-download", "--port", str(port), "--device", device]
        if readout:
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-host", *cli, "--metrics-port", "0"]
        else:
            cmd = [sys.executable, "-m", "lumen_tpu_torch.serving.server", *cli]
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE if readout else self.log,
            stderr=self.log if readout else subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT), **extra_env},
        )
        self.lines: queue.Queue = queue.Queue()
        self.reader = None
        if readout:
            self.reader = threading.Thread(target=lambda: [self.lines.put(line) for line in self.proc.stdout],
                                           daemon=True)
            self.reader.start()
        self.channel = self.metrics_port = None

    def _serving_line(self, timeout: float) -> dict:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                if self.proc.poll() is not None and self.lines.empty():
                    raise AssertionError(f"{self.name} exited with {self.proc.returncode}: {self.log_path}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{self.name} was not serving within {timeout:.0f} s: {self.log_path}")
                continue
            if line.startswith("{"):
                return json.loads(line)

    def wait(self, timeout: float = 300.0):
        import grpc
        from google.protobuf import empty_pb2

        from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub

        self.channel = grpc.insecure_channel(f"127.0.0.1:{self.port}")
        stub = InferenceStub(self.channel)
        if self.readout:
            self.metrics_port = self._serving_line(timeout)["metrics_port"]
            grpc.channel_ready_future(self.channel).result(timeout=60)
            return stub
        t0 = time.perf_counter()
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited with {self.proc.returncode}: {self.log_path}")
            try:
                stub.Health(empty_pb2.Empty(), timeout=10)
                return stub
            except grpc.RpcError:
                if time.perf_counter() - t0 > timeout:
                    raise
                time.sleep(0.2)

    def stop(self, timeout: float = 60.0) -> dict:
        import queue

        if self.channel is not None:
            self.channel.close()
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            raise AssertionError(f"{self.name} did not exit within {timeout:.0f} s of SIGTERM: {self.log_path}")
        finally:
            self.log.close()
        if rc != 0:
            raise AssertionError(f"{self.name} exited with {rc}: {self.log_path}")
        if not self.readout:
            return {}
        self.reader.join(timeout=30)
        last = {}
        with contextlib.suppress(queue.Empty):
            while True:
                line = self.lines.get_nowait()
                if line.startswith("{"):
                    last = json.loads(line)
        if not READOUT_KEYS <= set(last):
            raise AssertionError(f"{self.name} exited without its readout (last line {last}): {self.log_path}")
        return last


def engine_gauges(port: int) -> dict:
    """The ``vlm-continuous:*`` gauges of the one engine behind a sidecar."""
    gauges = http_json(port, "/metrics.json").get("gauges", {})
    (name,) = [k for k in gauges if k.startswith("vlm-continuous:")]
    return gauges[name]


def drive_fleet(seed: int, card: str, root: Path, phase6: dict, device: str = "cuda:0", n_captions: int = 8,
                n_streams: int = 2, max_new: int = 32, fallback_new: int = 96, drain: bool = True,
                search: bool = True, n_vectors: int = 50_000, n_queries: int = 128, dim: int = 512,
                timeout: float = 600.0) -> dict:
    """Phase 13: a disaggregated fleet of three hosts on one card, over
    loopback gRPC. A prefill host (``LUMEN_FED_ROLE=prefill``) and a front
    tier (no service, ``LUMEN_FED_PEERS`` naming both backends) run as
    processes of their own (:class:`ServerProcess`); the decode host
    (``LUMEN_FED_ROLE=decode``) is ``serve()`` in this process, so its
    launch counts are read here. All serve phase 6's directory on
    ``device``, with capacity gossip on, ``LUMEN_FED_KV_LANES`` at the
    concurrency and the result cache off (a control must compute, not find
    a peer's answer). (a) ``n_captions`` greedy ``vlm_generate`` and
    ``n_streams`` streams of phase 6's JPEGs through the front, all at once,
    ``max_new`` tokens each: every row migrates (``migrated_out`` and
    ``migrated_in`` equal the request count, no fallback, no rejection), the
    decode host launches no prefill kernel and the paged kernel, every
    answer equals the same request on one colocated host (the decode host,
    asked directly), both hosts end with no live page. (b) ``n_streams``
    streams whose decode host is stopped while they decode: they finish on
    the prefill host's ladder (``resubmit_spilled``), equal to their
    control, with no token repeated. (c) SIGTERM to the prefill host with
    ``LUMEN_DRAIN_ANNOUNCE_S``: the front records one drain handoff and no
    ``fed_peer_down`` for it. (d) two ``search`` backends behind a front
    tier hold ``n_vectors`` seeded unit vectors at ``dim``; ``n_queries``
    queries at k = 10 equal the exact oracle outside near-ties. ``drain``,
    ``search`` and the sizes let the CPU tests rehearse (a) and (b)
    small."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    import numpy as np
    import torch

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    all_k = all_kernels()
    photos, prompt = phase6["photos"], phase6["prompt"]
    n_req = n_captions + n_streams
    ports = {h: free_port() for h in ("prefill", "decode", "front")}
    addr = {h: f"127.0.0.1:{p}" for h, p in ports.items()}
    peers = f"{addr['prefill']},{addr['decode']}"
    fleet = dict(LUMEN_FED_PEERS=peers, LUMEN_FED_CAPACITY="1", LUMEN_FED_KV_LANES=str(n_req),
                 LUMEN_FED_POLL_S="0.5", LUMEN_CACHE_BYTES="0", LUMEN_VLM_SPEC_K="0")
    out: dict = {}
    hosts: dict = {}
    stopped: list = []  # hosts that failed to stop cleanly
    decode = dchan = None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    try:
        with env(**fleet, LUMEN_FED_ROLE="decode", LUMEN_FED_SELF=addr["decode"]):
            reset_result_cache()  # this process's cache, off as the other hosts' are
            hosts["prefill"] = ServerProcess(
                "prefill host", fleet_yaml(root / "fleet-prefill.yaml", root / "cache", "SmokeVLM", ports["prefill"]),
                ports["prefill"], device, root / "fleet-prefill.log",
                {**fleet, "LUMEN_FED_ROLE": "prefill", "LUMEN_FED_SELF": addr["prefill"],
                 "LUMEN_DRAIN_S": "30", "LUMEN_DRAIN_ANNOUNCE_S": "10"}, readout=True)
            t0 = time.perf_counter()
            decode = serve(load_config(str(fleet_yaml(root / "fleet-decode.yaml", root / "cache", "SmokeVLM",
                                                      ports["decode"]))),
                           port_override=ports["decode"], skip_download=True, device=device)
            decode_s = time.perf_counter() - t0
            dchan = grpc.insecure_channel(addr["decode"])
            dstub = InferenceStub(dchan)
            hosts["prefill"].wait()
            # The front starts once both backends answer, so its record of
            # peers going down begins with a healthy fleet.
            hosts["front"] = ServerProcess(
                "front tier", fleet_yaml(root / "fleet-front.yaml", root / "cache", "SmokeVLM", ports["front"],
                                         enabled=False),
                ports["front"], device, root / "fleet-front.log", {**fleet, "LUMEN_DRAIN_S": "0"}, readout=True)
            fstub = hosts["front"].wait()
            boot_s = time.perf_counter() - t0
            if decode.router.kv_migration is None or decode.federation is None:
                raise AssertionError("phase 13: the decode host has no KV migration sink")
            eng = decode.services["vlm"].manager.engine
            front_port = hosts["front"].metrics_port
            deadline = time.monotonic() + 60
            while True:  # both lanes learned and live at the front, the decode host live at the prefill host
                view = http_json(front_port, "/peers")["peers"]
                roles = {n: p["fed_role"] for n, p in view.items()}
                states = {n: p["state"] for n, p in view.items()}
                at_prefill = http_json(hosts["prefill"].metrics_port, "/peers")["peers"][addr["decode"]]["state"]
                if roles == {addr["prefill"]: "prefill", addr["decode"]: "decode"} and set(
                        states.values()) == {"serving"} and at_prefill == "serving":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 13: the fleet never settled: lanes {roles}, states {states}, "
                                         f"decode host at the prefill host {at_prefill}")
                time.sleep(0.1)
            log(f"phase 13: fleet up in {boot_s:.2f} s (decode host serve() {decode_s:.2f} s): prefill "
                f"{addr['prefill']} (process), decode {addr['decode']} (this process), front {addr['front']} "
                f"(process, no service); lanes {json.dumps(roles)}; kv {decode.services['vlm'].manager.kv_layout()}")

            # -- (a) migrated leg, then the same requests colocated ------------------
            class TimedSink:
                """The decode host's sink, timing each commit from the handler's
                start (its one frame received and parsed) to ``submit_migrated``
                returning (CRC, unpack, record build, admission), and from there
                to the first relayed token frame; it keeps the first commit's
                frame for the loopback rate."""

                def __init__(self, svc, eng):
                    self.svc, self.eng, self.unpack_ms, self.first_ms, self.frame = svc, eng, [], [], None
                    self.local = threading.local()
                    real = eng.submit_migrated

                    def submit(*a, **kw):
                        real(*a, **kw)
                        self.local.t = time.perf_counter()

                    eng.submit_migrated = submit

                def handle_kv_put(self, first, it, ctx):
                    if first.meta.get("op") != "commit":
                        yield from self.svc.handle_kv_put(first, it, ctx)
                        return
                    self.frame = self.frame or first
                    t, self.local.t = time.perf_counter(), None
                    for resp in self.svc.handle_kv_put(first, it, ctx):
                        if self.local.t is not None and resp.meta.get("fed_kv") == "tok":
                            self.unpack_ms.append((self.local.t - t) * 1e3)
                            self.first_ms.append((time.perf_counter() - self.local.t) * 1e3)
                            self.local.t = None
                        yield resp

                def close(self):
                    del self.eng.submit_migrated  # the class's own again

            sink = TimedSink(decode.router.kv_migration, eng)
            decode.router.kv_migration = sink
            # Streams first: in both legs they start at once, with 6 captions.
            kinds = ["vlm_generate_stream"] * n_streams + ["vlm_generate"] * n_captions
            jobs = [(kind, photos[i], {"messages": prompt, "max_new_tokens": max_new}) for i, kind in enumerate(kinds)]

            def run(stub, js):
                with ThreadPoolExecutor(max_workers=8) as pool:
                    t = time.perf_counter()
                    res = list(pool.map(lambda j: grpc_call(stub, *j, timeout=timeout), js))
                    return res, time.perf_counter() - t

            gauges0 = engine_gauges(hosts["prefill"].metrics_port)
            d0 = dict(eng.gauges())
            for k in all_k:
                k.launches = 0
            migrated, mig_wall = run(fstub, jobs)
            launches = {k.name: k.launches for k in all_k}
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            pg = engine_gauges(hosts["prefill"].metrics_port)
            dg = eng.gauges()
            kv = http_json(hosts["prefill"].metrics_port, "/peers")["kv_migration"]
            decode.router.kv_migration = sink.svc
            sink.close()
            control, col_wall = run(dstub, jobs)
            for i, (m, c) in enumerate(zip(migrated, control)):
                if m["code"] or c["code"]:
                    raise AssertionError(f"phase 13 (a): request {i} codes {m['code']} (fleet) / {c['code']} (control)")
                if (m["body"]["generated_tokens"], m["body"]["text"]) != (c["body"]["generated_tokens"],
                                                                          c["body"]["text"]):
                    raise AssertionError(f"phase 13 (a): request {i} migrated differs from colocated: "
                                         f"{m['body']['text'][:60]!r} vs {c['body']['text'][:60]!r}")
                if m["deltas"] and b"".join(m["deltas"]).decode() != m["body"]["text"]:
                    raise AssertionError(f"phase 13 (a): stream {i}'s deltas do not join to its text")
            moved = {k: pg[k] - gauges0[k] for k in ("migrated_out", "migrate_out_failed")}
            moved_in = {k: dg[k] - d0[k] for k in ("migrated_in", "migrate_in_rejected")}
            if moved != {"migrated_out": n_req, "migrate_out_failed": 0} or moved_in != {
                    "migrated_in": n_req, "migrate_in_rejected": 0}:
                raise AssertionError(f"phase 13 (a): prefill {moved}, decode {moved_in} for {n_req} requests")
            if any(launches[n] for n in PHASE13_NO_PREFILL) or any(launches[n] == 0 for n in PHASE13_DECODE_KERNELS):
                raise AssertionError(f"phase 13 (a): decode-host launches {launches}")
            deadline = time.monotonic() + 30
            while (pg["pages_live"] or eng.gauges()["pages_live"]) and time.monotonic() < deadline:
                time.sleep(0.05)
                pg = engine_gauges(hosts["prefill"].metrics_port)
            if pg["pages_live"] or eng.gauges()["pages_live"]:
                raise AssertionError(f"phase 13 (a): pages live at the end: prefill {pg['pages_live']}, "
                                     f"decode {eng.gauges()['pages_live']}")
            row_bytes = kv["put_bytes"] / max(kv["puts"], 1)
            # The loopback rate: a real commit (one frame: 48 MB chunks) sent
            # again with op=offer, which the sink answers without unpacking.
            frame = pb.InferRequest.FromString(sink.frame.SerializeToString())
            frame.meta["op"] = "offer"
            frame_bytes = frame.ByteSize()
            offer = lambda: list(dstub.Infer(iter([frame]), timeout=60))  # noqa: E731
            offer()
            rate_s = []
            for _ in range(10):
                t = time.perf_counter()
                offer()
                rate_s.append(time.perf_counter() - t)
            tok = lambda rs: sum(r["body"]["generated_tokens"] for r in rs)  # noqa: E731
            ttft = lambda rs: sorted(r["ttft_ms"] for r in rs if r["ttft_ms"] is not None)  # noqa: E731
            answer = lambda rs: sorted(r["s"] * 1e3 for r in rs[n_streams:])  # noqa: E731
            pct = lambda xs, p: float(xs[min(len(xs) - 1, int(p * len(xs)))])  # noqa: E731
            out.update(
                requests=n_req, puts=kv["puts"], row_bytes=row_bytes, commit_unpack_ms=sorted(sink.unpack_ms),
                commit_first_ms=sorted(sink.first_ms), frame_bytes=frame_bytes,
                loopback_bytes_s=frame_bytes / float(np.median(rate_s)), launches=launches, peak_gib=peak / 2**30,
                ttft_migrated=ttft(migrated), ttft_colocated=ttft(control), answer_migrated=answer(migrated),
                answer_colocated=answer(control), tok_s_migrated=tok(migrated) / mig_wall,
                tok_s_colocated=tok(control) / col_wall)
            log(f"phase 13 (a): {n_req} requests through the front ({n_captions} vlm_generate + {n_streams} streams, "
                f"8 in flight, {max_new} new tokens, 1600x1200 JPEGs): every one migrated (prefill {json.dumps(moved)}, "
                f"decode {json.dumps(moved_in)}), all {n_req} equal to the colocated control; decode-host launches "
                f"{json.dumps(launches)}; pages live at the end 0 / 0 [{card}]")
            log(f"phase 13 (a): KV shipped {row_bytes / 1e6:.3f} MB a row ({kv['puts']} commits, "
                f"{kv['put_bytes']} B in all, {kv['ref_pages']} pages by reference); on the decode host, from a "
                f"commit's frame received to its row admitted (CRC, unpack, record, submit_migrated) p50 / max "
                f"{pct(out['commit_unpack_ms'], 0.5):.2f} / {out['commit_unpack_ms'][-1]:.2f} ms, admitted to the "
                f"first relayed token p50 / max {pct(out['commit_first_ms'], 0.5):.2f} / "
                f"{out['commit_first_ms'][-1]:.2f} ms (of {len(sink.first_ms)}); one commit frame "
                f"({frame_bytes} B, sent as an offer) round trip on loopback gRPC "
                f"{out['loopback_bytes_s'] / 1e9:.3f} GB/s (median of 10) [{card}]")
            log(f"phase 13 (a): stream TTFT p50 / p95 migrated {pct(out['ttft_migrated'], 0.5):.1f} / "
                f"{pct(out['ttft_migrated'], 0.95):.1f} ms, colocated {pct(out['ttft_colocated'], 0.5):.1f} / "
                f"{pct(out['ttft_colocated'], 0.95):.1f} ms; vlm_generate answer p50 / p95 migrated "
                f"{pct(out['answer_migrated'], 0.5):.1f} / {pct(out['answer_migrated'], 0.95):.1f} ms, colocated "
                f"{pct(out['answer_colocated'], 0.5):.1f} / {pct(out['answer_colocated'], 0.95):.1f} ms; aggregate "
                f"{out['tok_s_migrated']:.1f} tok/s migrated, {out['tok_s_colocated']:.1f} colocated; decode-host "
                f"peak {out['peak_gib']:.3f} GiB since the phase began [{card}]")

            # -- (b) the decode host stops while two streams decode on it ----------
            fb_jobs = [("vlm_generate_stream", photos[n_req + i], {"messages": prompt, "max_new_tokens": fallback_new})
                       for i in range(n_streams)]
            fb_control, _ = run(dstub, fb_jobs)
            in0 = eng.migrated_in
            box: dict = {}
            runner = threading.Thread(target=lambda: box.update(res=run(fstub, fb_jobs)[0]), daemon=True)
            runner.start()
            deadline = time.monotonic() + timeout
            while True:  # freeze the decode loop once both rows streamed a block
                eng._cond.acquire()
                rows = [s for s in eng._slots.values() if s.request.embeds is None]  # migrated in: no prompt here
                if eng.migrated_in - in0 == n_streams and len(rows) == n_streams and all(
                        len(s.tokens) >= eng.block for s in rows):
                    break
                eng._cond.release()
                if time.monotonic() > deadline or not runner.is_alive():
                    raise AssertionError("phase 13 (b): the streams never decoded on the decode host")
                time.sleep(0.0005)
            try:
                streamed = [len(s.tokens) for s in rows]
                decode.server.stop(0).wait(10)  # the wire dies mid-stream
            finally:
                eng._cond.release()
            decode.stop(grace=0.1)
            decode = None
            runner.join(timeout=timeout)
            if runner.is_alive():
                raise AssertionError("phase 13 (b): the streams never finished")
            fb = box["res"]
            for i, (m, c) in enumerate(zip(fb, fb_control)):
                if m["code"] or (m["body"]["generated_tokens"], m["body"]["text"]) != (
                        c["body"]["generated_tokens"], c["body"]["text"]):
                    raise AssertionError(f"phase 13 (b): stream {i} differs from its control (code {m['code']})")
                if b"".join(m["deltas"]).decode() != m["body"]["text"]:
                    raise AssertionError(f"phase 13 (b): stream {i} repeated or lost a token")
            pg2 = engine_gauges(hosts["prefill"].metrics_port)
            fallbacks = pg2["migrate_out_failed"] - pg["migrate_out_failed"]
            if fallbacks != n_streams:
                raise AssertionError(f"phase 13 (b): {fallbacks} fallbacks for {n_streams} streams")
            out.update(fallbacks=fallbacks)
            log(f"phase 13 (b): decode host stopped with {n_streams} streams on it ({streamed} tokens each already "
                f"out): {fallbacks} fallbacks through resubmit_spilled, both streams finished on the prefill host "
                f"equal to their control, no token repeated [{card}]")

            # -- (c) the prefill host drains --------------------------------------
            if drain:
                before = http_json(front_port, "/metrics.json").get("counters", {}).get("fed_drain_handoffs", 0)
                hosts["prefill"].proc.terminate()
                t0 = time.monotonic()
                while True:
                    peer = http_json(front_port, "/peers")["peers"][addr["prefill"]]
                    if peer.get("draining") and peer.get("weight") == 0.0:
                        break
                    if time.monotonic() - t0 > 30:
                        raise AssertionError(f"phase 13 (c): the front never saw the drain: {peer}")
                    time.sleep(0.05)
                seen_s = time.monotonic() - t0
                handoffs = http_json(front_port, "/metrics.json").get("counters", {}).get(
                    "fed_drain_handoffs", 0) - before
                events = http_json(front_port, "/events")["events"]
                down = [e for e in events if e["kind"] == "fed_peer_down" and e["component"] == addr["prefill"]]
                hand = [e for e in events if e["kind"] == "fed_drain_handoff" and e["component"] == addr["prefill"]]
                if handoffs != 1 or len(hand) != 1 or down:
                    raise AssertionError(f"phase 13 (c): {handoffs} handoffs, events {hand}, peer-down {down}")
                out["prefill_host"] = hosts.pop("prefill").stop()
                log(f"phase 13 (c): SIGTERM to the prefill host: the front saw draining and weight 0 after "
                    f"{seen_s:.2f} s, 1 drain handoff, no fed_peer_down for it; prefill host launches "
                    f"{json.dumps(out['prefill_host']['launches'])}, peak {out['prefill_host']['peak_gib']:.3f} GiB "
                    f"[{card}]")
    finally:
        if dchan is not None:
            dchan.close()
        if decode is not None:
            decode.stop(grace=0.1)
        for name in list(hosts):  # stop every host before raising for one
            try:
                out[f"{name}_host"] = hosts.pop(name).stop()
            except AssertionError as e:
                log(f"phase 13: {e}")
                stopped.append(e)
    if stopped:
        raise stopped[0]
    front = out["front_host"]
    if front["cuda_initialized"] or any(front["launches"].values()):
        raise AssertionError(f"phase 13: the front tier touched the device: {front}")
    log(f"phase 13: front tier launches {json.dumps(front['launches'])}, CUDA initialized "
        f"{front['cuda_initialized']} [{card}]")

    # -- (d) search fan-out over two backends ---------------------------------
    if search:
        out.update(drive_fleet_search(seed, card, root, device, n_vectors, n_queries, dim))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 13 (d)'s shards: with 3 (the default) a ring of two peers puts
#: every shard on one peer a quarter of the time; with 8, 2 in 256
FLEET_SEARCH_SHARDS = 8


def drive_fleet_search(seed: int, card: str, root: Path, device: str, n_vectors: int, n_queries: int,
                       dim: int) -> dict:
    """Phase 13 (d): two ``search`` backends (``serve()`` in this process)
    behind a front tier, ``FLEET_SEARCH_SHARDS`` shards a tenant:
    ``n_vectors`` seeded unit vectors upserted through the front in
    1,024-row chunks (partitioned by shard: each backend holds exactly the
    rows of the shards the front's ring gives it), then ``n_queries``
    queries at k = 10 over every shard, each held to the numpy oracle
    outside near-ties (phase 11's rule)."""
    with env(LUMEN_ANN_SHARDS=str(FLEET_SEARCH_SHARDS)):
        return _drive_fleet_search(seed, card, root, device, n_vectors, n_queries, dim)


def _drive_fleet_search(seed: int, card: str, root: Path, device: str, n_vectors: int, n_queries: int,
                        dim: int) -> dict:
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from lumen_tpu_torch.runtime.ann import normalize, shard_of
    from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, pack_bundle

    yaml_path = ocr_yaml(root / "fleet-search.yaml", root / "cache",
                         {"search": ("ann-exact", {"batch_size": 16, "max_batch_latency_ms": 2.0})})
    backends = []
    front = channel = None
    try:
        for _ in range(2):
            with env(LUMEN_ANN_DIM=str(dim)):
                handle, ch, _, _ = boot_server(yaml_path, device)
            ch.close()
            backends.append(handle)
        peers = ",".join(f"127.0.0.1:{h.port}" for h in backends)
        import yaml

        spec = yaml.safe_load(yaml_path.read_text())
        spec["services"]["search"]["enabled"] = False
        (root / "fleet-search-front.yaml").write_text(yaml.safe_dump(spec))
        with env(LUMEN_FED_PEERS=peers, LUMEN_FED_SELF=""):
            front, channel, stub, _ = boot_server(root / "fleet-search-front.yaml", device)
        rng = np.random.default_rng(seed * 100 + 13)
        vecs = normalize(rng.standard_normal((n_vectors, dim), dtype=np.float32))
        ids = [f"fv{i:06d}" for i in range(n_vectors)]
        chunk = 1024
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            ups = list(ex.map(lambda lo: grpc_call(stub, "search_upsert", pack_bundle([
                vecs[lo:lo + chunk], np.frombuffer(json.dumps(ids[lo:lo + chunk]).encode(), np.uint8)]),
                {}, mime=BUNDLE_MIME), range(0, n_vectors, chunk)))
        upsert_s = time.perf_counter() - t0
        if any(r["code"] for r in ups) or sum(r["body"]["added"] for r in ups) != n_vectors:
            raise AssertionError(f"phase 13 (d): upserts answered {[r['code'] for r in ups]}, "
                                 f"{sum(r.get('body', {}).get('added', 0) for r in ups)} rows added")
        held = [sum(s._n for s in h.services["search"].index.shards_for("default").values()) for h in backends]
        ring = front.federation.ring
        owner = {sh: ring.owner(hashlib.sha256(f"ann/default/{sh}".encode()).hexdigest())
                 for sh in range(FLEET_SEARCH_SHARDS)}
        placed = [sum(owner[shard_of(i, FLEET_SEARCH_SHARDS)] == f"127.0.0.1:{h.port}" for i in ids) for h in backends]
        if held != placed:
            raise AssertionError(f"phase 13 (d): the backends hold {held} rows, the ring places {placed}")
        queries = normalize(rng.standard_normal((n_queries, dim), dtype=np.float32))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as ex:
            answers = list(ex.map(lambda q: grpc_call(stub, "search_query", json.dumps(
                {"vector": q.tolist()}).encode(), {"k": "10"}, mime="application/json"), queries))
        query_s = time.perf_counter() - t0
        scores = queries @ vecs.T
        near, worst = 0, 0.0
        for j, r in enumerate(answers):
            if r["code"] or r["body"]["shards"] != FLEET_SEARCH_SHARDS:
                raise AssertionError(f"phase 13 (d): query {j}: {r['code']} {r.get('body')}")
            want_ids, want_scores, gap = oracle_topk(scores[j], ids, 10)
            worst = max(worst, float(np.abs(np.asarray(r["body"]["scores"]) - want_scores).max()))
            if gap < SEARCH_SCORE_TOL:
                near += 1
            elif r["body"]["ids"] != want_ids:
                raise AssertionError(f"phase 13 (d): query {j} differs from the oracle")
        if worst > SEARCH_SCORE_TOL:
            raise AssertionError(f"phase 13 (d): scores differ from the oracle's by {worst:.2e}")
        log(f"phase 13 (d): two search backends behind a front: {n_vectors:,} unit vectors at dim {dim} upserted "
            f"through the front in {upsert_s:.2f} s (held {held}, {FLEET_SEARCH_SHARDS} shards placed by the front's ring), {n_queries} queries at k = 10 in {query_s:.2f} s "
            f"(16 in flight), every answer the oracle's but {near} near-ties, scores within {worst:.2e} [{card}]")
        return {"search_held": held, "search_near_ties": near, "search_upsert_s": upsert_s,
                "search_query_s": query_s}
    finally:
        if channel is not None:
            channel.close()
        if front is not None:
            front.stop(grace=0.5)
        for h in backends:
            h.stop(grace=0.5)


# -- phase 14: the control plane as users reach it --------------------------------

#: the kernels the supervised full tier must launch (its vision tower, CLIP,
#: face and OCR all run on the ONNX bridge; phases 2-13 hold the others)
PHASE14_KERNELS = ("flash_attention_cache", "paged_attention")
#: the catalog names ``config_gen`` writes for the full tier, each served by
#: an earlier phase's stand-in: phase 12 (a)'s FastVLM-shaped directory,
#: phase 9 (c)'s export-only CLIP, phase 9 (a)'s pack, phase 10 (a)'s pack
CATALOG_SOURCES = {"FastVLM-0.5B": "SmokeFastVLM", "MobileCLIP2-S2": "SmokeMobileCLIP", "buffalo_l": "buffalo_l",
                   "PP-OCRv5_mobile": "PP-OCRv5_mobile"}
#: what each client subcommand's answer is held to
CLIENT_SCHEMAS = {"embed-text": "embedding_v1", "embed-image": "embedding_v1", "faces": "face_v1",
                  "ocr": "ocr_v1", "caption": "text_generation_v1", "caption --stream": "text_generation_v1"}
#: the tasks ``GET /api/v1/metrics`` must count after (d)
PHASE14_TASKS = ("clip_text_embed", "clip_image_embed", "face_detect", "ocr", "vlm_generate", "vlm_generate_stream")


def link_model_dir(src: Path, dst: Path, runtime: str) -> None:
    """``dst`` (a catalog name under the cache) holding links to each entry
    of ``src`` and its own ``model_info.json``: the catalog name, and the
    source's declared files under the ``runtime`` the YAML names too."""
    dst.mkdir(parents=True)
    for entry in src.iterdir():
        if entry.name != "model_info.json":
            (dst / entry.name).symlink_to(entry.resolve())
    info = json.loads((src / "model_info.json").read_text())
    files = next(r["files"] for r in info["runtimes"].values() if r.get("available"))
    info["name"] = dst.name
    info["runtimes"][runtime] = {"available": True, "files": files}
    (dst / "model_info.json").write_text(json.dumps(info))


def run_cli(args: list, timeout: float = 600, **kw) -> subprocess.CompletedProcess:
    """A ``python -m`` command of the port from the checkout's root; raises
    unless it exits 0."""
    out = subprocess.run([sys.executable, "-m", *map(str, args)], capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT)}, **kw)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(map(str, args[:3]))} exited with {out.returncode}:\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-4000:]}")
    return out


def split_stream(stdout: str) -> tuple[str, dict]:
    """``client caption --stream``'s output: the streamed text, then a
    newline and the final answer's JSON."""
    at = stdout.rindex("\n{\n")
    return stdout[:at], json.loads(stdout[at + 1:])


def drive_control_plane(card: str, root: Path, photos: list, sources: dict, device: str = "cuda:0",
                        preset: str | None = None, timeout: float = 900.0, caption_tokens: int = 64) -> dict:
    """Phase 14: the control plane as users reach it. (a) ``hardware_report()``
    in a fresh process: the card's name and count, the recommended preset,
    and no CUDA context in that process; ``environment_report`` there. (b)
    the app (``lumen_tpu_torch.app``, in process, aiohttp on a loopback port,
    real HTTP): ``hardware/detect``, ``config/generate`` (the recommended
    preset, or ``preset``; ``tier: full``) into a temporary cache holding the
    stand-ins under the catalog names (``sources``: catalog name -> model
    directory, linked), ``config/save``; the resources CLI's ``validate``,
    ``list`` and ``download`` on the saved YAML (nothing to fetch); and
    ``install/setup`` with a venv and the model check. (c) ``server/start``
    of the full tier under the app's ``ServerManager`` (``chip_smoke.py
    --serve-host``) with ``LUMEN_COMPILE_CACHE_DIR`` empty: healthy; a
    greedy caption over gRPC builds its kernels at first use, counted in
    ``/stats``' ``compile`` block. (d) ``python -m lumen_tpu_torch.client``:
    every subcommand exits 0 with a schema-valid answer on ``photos[0]``, the
    client's caption equal to that gRPC one, and ``/api/v1/metrics``
    counting the tasks; then ``server/restart`` from the warm directory, the
    same caption again with no build. (e) ``server/stop``: both children
    exit 0, and their readouts (``/api/v1/server/logs``) show the path's
    kernels launched. Off the card ``preset`` names the preset and the saved
    YAML is edited to ``device: cpu`` (the wizard's YAML editor). Every
    caption asks ``caption_tokens`` new tokens."""
    import asyncio

    import yaml

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.core.downloader import Downloader
    from lumen_tpu_torch.core.result_schemas import validate_result

    on_card = device != "cpu"
    t_phase = time.perf_counter()
    work = root / "control"
    cache = work / "cache"
    work.mkdir()
    out: dict = {}

    # -- (a) hardware detection in a fresh process -----------------------------------
    code = ("import json, sys\n"
            "from lumen_tpu_torch.app.env_check import environment_report\n"
            "from lumen_tpu_torch.app.hardware import hardware_report\n"
            "report = hardware_report()\n"
            "env = environment_report(sys.argv[1], 1.0)\n"
            "import torch\n"
            "print(json.dumps({'report': report, 'env': env, 'cuda_initialized': torch.cuda.is_initialized()}))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code, str(work)], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    if res.returncode != 0:
        raise AssertionError(f"phase 14 (a): the probing process exited with {res.returncode}:\n{res.stderr[-3000:]}")
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    report, hw = seen["report"], seen["report"]["hardware"]
    checks = {c["name"]: c for c in seen["env"]["checks"]}
    if seen["cuda_initialized"]:
        raise AssertionError("phase 14 (a): the process that called hardware_report() holds a CUDA context")
    if on_card:
        import torch

        name = card.split(",")[0].strip()
        if (hw["platform"], hw["device_kind"], hw["device_count"]) != ("cuda", name, torch.cuda.device_count()):
            raise AssertionError(f"phase 14 (a): detected {hw}, nvidia-smi says {card!r}")
        if report["recommended_preset"] != "cuda_h100_1":
            raise AssertionError(f"phase 14 (a): recommended {report['recommended_preset']}")
        bad = [n for n in ("torch", "torch_cuda", "nvcc", "nvidia_driver", "gpu_devices") if not checks[n]["ok"]]
        if bad:
            raise AssertionError(f"phase 14 (a): environment checks failed: {[checks[n] for n in bad]}")
    preset = preset or report["recommended_preset"]
    verdicts = ", ".join(f"{n} {c['ok']}" for n, c in checks.items())
    log(f"phase 14 (a): hardware_report() in a fresh process ({time.perf_counter() - t0:.1f} s): "
        f"{hw['platform']} '{hw['device_kind']}' x{hw['device_count']}, {hw['device_memory_gb']} GB, recommends "
        f"{report['recommended_preset']} (supported {report['supported_presets']}); CUDA initialized in that process: "
        f"{seen['cuda_initialized']}; env checks {verdicts}; nvcc: {checks['nvcc']['detail']} [{card}]")

    async def drive() -> None:
        import aiohttp
        from aiohttp import web

        from lumen_tpu_torch.app.api import MANAGER_KEY, build_app
        from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub

        app = build_app()
        manager = app[MANAGER_KEY]
        # The supervised server is the port's CLI under --serve-host, which
        # prints its launches and peak memory when it stops.
        manager.server_argv = (sys.executable, str(ROOT / "chip_smoke.py"), "--serve-host")
        runner = web.AppRunner(app)
        await runner.setup()
        app_port = free_port()
        await web.TCPSite(runner, "127.0.0.1", app_port).start()
        base = f"http://127.0.0.1:{app_port}/api/v1"
        http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=timeout))

        async def call(method: str, path: str, body: dict | None = None, status: int = 200):
            async with http.request(method, base + path, json=body) as r:
                data = await r.json(content_type=None)
                if r.status != status:
                    raise AssertionError(f"phase 14: {method} {path} answered {r.status}: {data}")
                return data

        async def cli(*args, **kw):
            return await asyncio.to_thread(run_cli, list(args), **kw)

        try:
            # -- (b) config, install and the resources CLI ---------------------------
            t0 = time.perf_counter()
            detect = await call("GET", "/hardware/detect")
            if detect["recommended_preset"] != report["recommended_preset"]:
                raise AssertionError(f"phase 14 (b): hardware/detect recommends {detect['recommended_preset']}")
            grpc_port = free_port()
            cfg = await call("POST", "/config/generate", {"preset": preset, "tier": "full", "cache_dir": str(cache),
                                                          "port": grpc_port, "mdns": False})
            models = {svc: next(iter(spec["models"].values())) for svc, spec in cfg["services"].items()}
            if sorted(m["model"] for m in models.values()) != sorted(sources):
                raise AssertionError(f"phase 14 (b): the full tier names {models}")
            for m in models.values():
                link_model_dir(Path(sources[m["model"]]), cache / "models" / m["model"], m["runtime"])
            yaml_path = work / "lumen.yaml"
            if on_card:
                await call("POST", "/config/save", {"path": str(yaml_path)})
            else:  # the wizard's YAML editor: serve the same tier on the CPU
                text = await (await http.get(base + "/config/yaml")).text()
                spec = yaml.safe_load(text)
                for svc in spec["services"].values():
                    svc["backend_settings"].update(device="cpu", dtype="float32")
                await call("POST", "/config/save", {"path": str(yaml_path), "yaml": yaml.safe_dump(spec)})
            devices = {s.backend_settings.device for s in load_config(str(yaml_path)).services.values()}
            check = Downloader(load_config(str(yaml_path))).check_all()  # offline: download must fetch nothing
            if not check.ok:
                raise AssertionError(f"phase 14 (b): models missing from the cache: {check.results}")
            await cli("lumen_tpu_torch.core.cli", "validate", "--config", yaml_path)
            listed = (await cli("lumen_tpu_torch.core.cli", "list", "--config", yaml_path)).stdout
            if sorted(line.split(": ")[1].split()[0] for line in listed.splitlines()) != sorted(sources):
                raise AssertionError(f"phase 14 (b): list printed {listed!r}")
            downloaded = (await cli("lumen_tpu_torch.core.cli", "download", "--config", yaml_path)).stdout
            task = await call("POST", "/install/setup", {"venv_path": str(work / "venv"), "config_path": str(yaml_path),
                                                         "download": True}, status=202)
            while task["status"] in ("pending", "running"):
                await asyncio.sleep(0.5)
                task = await call("GET", f"/install/status/{task['task_id']}")
            steps = [(s["name"], s["status"]) for s in task["steps"]]
            want = [(n, "completed") for n in ("check_python", "create_venv", "verify_imports", "download_models")]
            if task["status"] != "completed" or steps != want:
                logs = await call("GET", f"/install/logs/{task['task_id']}?limit=40")
                raise AssertionError(f"phase 14 (b): install {task['status']} {steps} {task['error']}: {logs['lines']}")
            out["setup_s"] = time.perf_counter() - t0
            log(f"phase 14 (b): config/generate {preset} tier full (devices {sorted(devices)}) over the catalog "
                f"names, saved; resources CLI validate, list ({len(listed.splitlines())} models) and download "
                f"({len(downloaded.splitlines())} ok, nothing fetched); install/setup with a venv: "
                f"{', '.join(f'{n} {s}' for n, s in steps)}; {out['setup_s']:.1f} s [{card}]")

            # -- (c) serve the full tier under the ServerManager ------------------------
            # Kernels build at first use, so the builds fall in the first
            # caption: timed on a cold directory, then on the warm one after
            # server/restart (the same greedy request both times).
            import grpc

            meta = {"messages": json.dumps([{"role": "user", "content": "Describe this photo in one sentence."}]),
                    "max_new_tokens": str(caption_tokens), "do_sample": "false"}

            async def first_caption(metrics_port: int) -> tuple[dict, float, dict]:
                t0 = time.perf_counter()
                with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
                    res = await asyncio.to_thread(grpc_call, InferenceStub(channel), "vlm_generate", photos[0], meta)
                took = time.perf_counter() - t0
                if res["code"]:
                    raise AssertionError(f"phase 14 (c): the first caption answered {res}")
                return res["body"], took, http_json(metrics_port, "/stats?window=3600")["compile"]

            extra = ["--skip-download", "--metrics-port", "0"]
            t0 = time.perf_counter()
            info = await call("POST", "/server/start", {"config_path": str(yaml_path), "extra_args": extra})
            cold_s = time.perf_counter() - t0
            status = await call("GET", "/server/status")
            if not status["healthy"] or info["port"] != grpc_port:
                raise AssertionError(f"phase 14 (c): status {status}")
            boot = http_json(info["metrics_port"], "/stats?window=3600")["compile"]
            direct, cold_first_s, cold = await first_caption(info["metrics_port"])
            if on_card and cold["compiles"] == 0:
                raise AssertionError(f"phase 14 (c): the cold server's first caption built nothing: {cold}")
            built = sorted(p.name for p in (work / "kernels").rglob("*.so"))
            out.update(cold_s=cold_s, cold_first_s=cold_first_s, boot_builds=boot["compiles"],
                       cold_builds=cold["compiles"], built=built, build_ms=(cold["ms"] or {}).get("mean_ms"))
            log(f"phase 14 (c): the full tier under the ServerManager, start to ready {cold_s:.2f} s on an empty "
                f"kernel directory ({boot['compiles']} builds at boot); the first caption {cold_first_s:.2f} s with "
                f"{cold['compiles']} builds ({out['build_ms']} ms a build on average: {', '.join(built)}) [{card}]")

            # -- (d) the client CLI -----------------------------------------------------
            t0 = time.perf_counter()
            photo = work / "photo.jpg"
            photo.write_bytes(photos[0])
            addr = ["lumen_tpu_torch.client", "--addr", f"127.0.0.1:{grpc_port}", "--timeout", "600", "--full"]
            jobs = {"caps": ["caps"], "health": ["health"], "topology": ["topology"],
                    "embed-text": ["embed-text", "a photo of a red car"], "embed-image": ["embed-image", photo],
                    "faces": ["faces", photo], "ocr": ["ocr", photo]}
            answers = dict(zip(jobs, await asyncio.gather(*(cli(*addr, *a) for a in jobs.values()))))
            tokens = ("--max-new-tokens", str(caption_tokens))
            answers["caption"] = await cli(*addr, "caption", photo, *tokens)
            answers["caption --stream"] = await cli(*addr, "caption", photo, "--stream", *tokens)
            for cmd, schema in CLIENT_SCHEMAS.items():
                text = answers[cmd].stdout
                if cmd == "caption --stream":
                    streamed, final = split_stream(text)
                    if streamed != final["text"]:
                        raise AssertionError(f"phase 14 (d): streamed {streamed!r}, final {final['text']!r}")
                    text = json.dumps(final)
                validate_result(schema, text.encode())
            caps = json.loads(answers["caps"].stdout)
            topo = json.loads(answers["topology"].stdout)
            if answers["health"].stdout != "ok\n" or not set(PHASE14_TASKS) <= set(caps["tasks"]) or len(topo) != 4:
                raise AssertionError(f"phase 14 (d): health {answers['health'].stdout!r}, caps {caps}, topology {topo}")
            caption = json.loads(answers["caption"].stdout)
            stream = split_stream(answers["caption --stream"].stdout)[1]
            if (direct["text"], direct["generated_tokens"]) != (caption["text"], caption["generated_tokens"]) or \
                    stream["text"] != caption["text"]:
                raise AssertionError(f"phase 14 (d): client caption {caption['text']!r}, stream {stream['text']!r}, "
                                     f"direct {direct['text']!r}")
            stats = json.loads((await cli("lumen_tpu_torch.client", "stats", "--metrics-addr",
                                          f"127.0.0.1:{info['metrics_port']}", "--window", "3600", "--json")).stdout)
            metrics = (await call("GET", "/metrics"))["inference"]
            counts = {t: metrics["tasks"].get(t, {}).get("count", 0) for t in PHASE14_TASKS}
            if not all(counts.values()) or not all(stats["tasks"].get(t, {}).get("count") for t in PHASE14_TASKS):
                raise AssertionError(f"phase 14 (d): /api/v1/metrics counts {counts}, stats {sorted(stats['tasks'])}")
            out.update(client_s=time.perf_counter() - t0, caption=caption["text"], counts=counts)
            log(f"phase 14 (d): the client's caps, health, topology, embed-text, embed-image, faces, ocr, caption, "
                f"caption --stream and stats exit 0, each answer valid against its schema; greedy caption "
                f"({caption['generated_tokens']} tokens) equal to the direct gRPC request and to the stream; "
                f"/api/v1/metrics counts {json.dumps(counts)}; {out['client_s']:.1f} s [{card}]")

            # -- (c, again) server/restart from the warm kernel directory ----------------
            t0 = time.perf_counter()
            info = await call("POST", "/server/restart")
            warm_s = time.perf_counter() - t0
            status = await call("GET", "/server/status")
            again, warm_first_s, warm = await first_caption(info["metrics_port"])
            if not status["healthy"] or warm["compiles"] != 0 or again["text"] != direct["text"]:
                raise AssertionError(f"phase 14 (c): warm builds {warm}, status {status}, caption {again['text']!r} "
                                     f"vs {direct['text']!r}")
            out.update(warm_s=warm_s, warm_first_s=warm_first_s)
            log(f"phase 14 (c): server/restart from the warm kernel directory, start to ready {warm_s:.2f} s; the "
                f"first caption {warm_first_s:.2f} s with {warm['compiles']} builds, equal to the cold one [{card}]")

            # -- (e) stop: each child's readout ------------------------------------------
            await call("POST", "/server/stop")
            info = await call("GET", "/server/status")
            messages = [line["message"] for line in (await call("GET", "/server/logs?limit=0"))["lines"]]
            readouts = [json.loads(m) for m in messages if m.startswith('{"launches"')]
            exits = [m for m in messages if m.startswith("server exited with code")]
            if info["exit_code"] != 0 or exits != ["server exited with code 0"] * 2 or len(readouts) != 2 or \
                    not all(READOUT_KEYS <= set(r) for r in readouts):
                raise AssertionError(f"phase 14 (e): exit code {info['exit_code']}, exits {exits}, readouts {readouts}")
            out.update(children=readouts, log_lines=len(messages))
        finally:
            await http.close()
            await runner.cleanup()  # stops a child still running

    with env(LUMEN_COMPILE_CACHE_DIR=str(work / "kernels"), LUMEN_CACHE_BYTES="0", HF_HUB_OFFLINE="1"):
        asyncio.run(drive())
    missing = [(child, k) for child, r in zip(("cold", "warm"), out["children"])
               for k in PHASE14_KERNELS if r["launches"][k] == 0]
    if on_card and missing:
        raise AssertionError(f"phase 14 (e): a supervised server never launched {missing}: {out['children']}")
    cold, warm = out["children"]
    out.update(launches={k: cold["launches"][k] + warm["launches"][k] for k in cold["launches"]},
               peak_gib=max(cold["peak_gib"], warm["peak_gib"]), phase_s=time.perf_counter() - t_phase)
    log(f"phase 14 (e): server/restart and server/stop, both children exited 0 ({out['log_lines']} lines read back "
        f"from the app's log buffer); launches while they served: cold "
        f"{json.dumps(cold['launches'])}, warm {json.dumps(warm['launches'])}; peaks {cold['peak_gib']:.3f} / "
        f"{warm['peak_gib']:.3f} GiB; phase 14 {out['phase_s']:.1f} s [{card}]")
    return out


# -- phase 15: a Qwen2-MoE decoder at Qwen1.5-MoE-A2.7B's widths -------------

#: the kernels phase 15 (a) must launch: the bf16 drive the three of the
#: bf16 path, the int8 + speculation drive the verify window and w8a16;
#: the <128> instances it must reach (by name, in the bf16 drive or the
#: int8 one), and those (b)'s server must launch
PHASE15_KERNELS = PHASE4_KERNELS
PHASE15_INT8_KERNELS = PHASE5_KERNELS
PHASE15_HD128 = {"bf16": ("flash_attention_cache", "paged_attention"), "int8": ("paged_attention_varq",),
                 "forward": ("flash_attention",)}
PHASE15_GRPC_KERNELS = PHASE4_KERNELS
#: the decoder's cacheless forward on the kernels against the plain
#: attention, both in bf16 through 24 MoE layers: cosine of the logits
MOE_FORWARD_COSINE = 0.995


def drive_moe(seed: int, card: str, root: Path, cfg=None, dir_cfg=None, device: str = "cuda:0") -> dict:
    """Phase 15: a Qwen2-MoE VLM (``testing/vlm_standins.qwen15_moe_a27b``:
    Qwen1.5-MoE-A2.7B's decoder, full width, 24 layers, behind the ViT
    tower) on the card. (a) seeded bf16 weights made on the card (no fp32
    copy) behind ``VLMManager`` on the paged engine: phase 4's drive, then
    the int8 + ``LUMEN_VLM_SPEC_K=4`` route on phase 5's templated prompts,
    then the decoder's cacheless forward on the kernels against the plain
    attention (``MOE_FORWARD_COSINE``); (b) a model directory of the same
    widths cut to 2 layers, served by ``serve()`` over gRPC: 8 streams in
    flight and one ``vlm_generate``, request 0 equal to a ``VLMManager``
    built from the same weights; (c) one ``MoEFFN`` layer at full width, 8
    tokens, against its plain per-expert loop, with its time, the grouped
    product's, and the byte bound of the experts the tokens chose.
    ``cfg``/``dir_cfg``/``device`` let the CPU tests rehearse it small
    (with the launch gates emptied)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager
    from lumen_tpu_torch.models.vlm import modeling as vlm_modeling
    from lumen_tpu_torch.models.vlm.chat import VlmTokenizer
    from lumen_tpu_torch.ops.attention import FLASH
    from lumen_tpu_torch.parallel import moe as M
    from lumen_tpu_torch.testing.vlm_standins import hf_config, qwen15_moe_a27b, seeded_state, write_model_dir
    from lumen_tpu_torch.utils.host_decode import vlm_canvas

    t_phase = time.perf_counter()
    cfg = cfg or qwen15_moe_a27b()
    dir_cfg = dir_cfg or qwen15_moe_a27b(layers=2)
    on_card = torch.device(device).type == "cuda"
    dec = cfg.decoder
    hd = dec.dim_per_head
    bf16 = torch.bfloat16
    out: dict = {}

    # -- (a) full width, full depth, on the paged engine -----------------
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = seeded_state(cfg, seed + 15, device, bf16)
    n_params = sum(v.numel() for v in state.values())
    log(f"phase 15 (a): Qwen1.5-MoE-A2.7B-width decoder ({dec.layers} layers, {dec.moe_experts} experts top-"
        f"{dec.moe_top_k}, head_dim {hd}) + ViT tower: {n_params / 1e9:.3f}B parameters seeded in bf16 on "
        f"{device} in {time.perf_counter() - t0:.1f} s, {sum(v.numel() * v.element_size() for v in state.values()) / 2**30:.2f} GiB")
    bf = drive_serving(seed, card, cfg=cfg, device=device, state=state, kernels=PHASE15_KERNELS,
                       label="phase 15 (a) bf16")
    q8 = drive_serving(seed, card, cfg=cfg, device=device, state=state, quantize="int8", spec_k=4,
                       kernels=PHASE15_INT8_KERNELS, label="phase 15 (a) int8 + spec K=4")
    for drive, names in ((bf, PHASE15_HD128["bf16"]), (q8, PHASE15_HD128["int8"])):
        missing = [n for n in names if not drive["instances"][n].get(hd)]
        if missing:
            raise AssertionError(f"phase 15 (a): the head_dim-{hd} instances of {missing} never launched "
                                 f"({json.dumps(drive['instances'])})")
    # The decoder's cacheless forward (the models' own entry point, which
    # the CPU parity tests run) on the same weights: its causal attention
    # is the head_dim-128 flash kernel; held to the plain attention.
    model = VLMManager._build_model(cfg, state).eval()
    rng = torch.Generator(device=device).manual_seed(seed + 151)
    ids = torch.randint(3, 1000, (1, 12), generator=rng, device=device)
    ids[0, 1] = cfg.image_token_id
    pixels = torch.randn((1, cfg.vision.image_size, cfg.vision.image_size, 3), generator=rng, device=device).to(bf16)
    for k in all_kernels():
        k.zero_counts()
    with torch.no_grad():
        got = model(ids, pixels).float()
        fwd_launches = {k.name: dict(k.instance_launches) for k in all_kernels()}
        with plain_attention(vlm_modeling):
            ref = model(ids, pixels).float()
    cos = float(cosines(got.flatten().cpu(), ref.flatten().cpu()))
    if not bool(torch.isfinite(got).all()) or got.shape != (1, 12 - 1 + cfg.vision.num_tokens, dec.vocab_size):
        raise AssertionError(f"phase 15 (a): the cacheless forward gave {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    if cos < MOE_FORWARD_COSINE:
        raise AssertionError(f"phase 15 (a): cacheless forward on the kernels vs plain attention: cosine {cos:.6f}")
    missing = [n for n in PHASE15_HD128["forward"] if not fwd_launches[n].get(hd)]
    if missing:
        raise AssertionError(f"phase 15 (a): the forward never reached the head_dim-{hd} {missing}: {fwd_launches}")
    del model, got, ref
    log(f"phase 15 (a): cacheless forward [1,{12 - 1 + cfg.vision.num_tokens}] on the kernels vs plain attention: "
        f"logit cosine {cos:.6f} (>= {MOE_FORWARD_COSINE}); launches by head_dim {json.dumps(fwd_launches)}")
    log(f"phase 15 (a) [{card}]: bf16 {bf['tok_s']:.1f} tok/s, int8 + spec {q8['tok_s']:.1f} tok/s (accept "
        f"{q8['spec_accepted']}/{q8['spec_proposed']}); peak GiB {bf['peak_gib']:.3f} / {q8['peak_gib']:.3f}; "
        f"head_dim-{hd} launches bf16 {json.dumps({n: v.get(hd, 0) for n, v in bf['instances'].items()})}, "
        f"int8 {json.dumps({n: v.get(hd, 0) for n, v in q8['instances'].items()})}")
    out.update(bf16=bf, int8=q8, forward_cos=cos, forward_launches=fwd_launches, params=n_params)
    del state
    if on_card:
        torch.cuda.empty_cache()

    # -- (b) a 2-layer model directory of the same widths over gRPC ------
    t0 = time.perf_counter()
    dstate = seeded_state(dir_cfg, seed + 152, device, bf16)
    if VLMConfig.from_hf(hf_config(dir_cfg)) != dir_cfg:
        raise AssertionError("phase 15 (b): config.json does not read back as the served configuration")
    model_dir = write_model_dir(root / "cache", "SmokeMoE", dir_cfg, dstate)
    gib = sum(f.stat().st_size for f in model_dir.iterdir()) / 2**30
    log(f"phase 15 (b): model directory ({dir_cfg.decoder.layers} of 24 layers, full width, HF Qwen2-MoE names) "
        f"written in {time.perf_counter() - t0:.1f} s, {gib:.2f} GiB")
    prompt = json.dumps([{"role": "user", "content": "describe this photo in one detailed sentence"}])
    photos = [photo_jpeg(seed * 100 + 50 + i) for i in range(9)]
    budgets = [24 + 4 * i for i in range(8)]
    all_k = all_kernels()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with env(LUMEN_VLM_SPEC_K="0"):
        handle, channel, stub, load_s = boot_server(
            deployment_yaml(root / "moe.yaml", root / "cache", "SmokeMoE", None), device)
    try:
        for k in all_k:
            k.zero_counts()
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            streams = list(pool.map(lambda i: grpc_call(
                stub, "vlm_generate_stream", photos[i], {"messages": prompt, "max_new_tokens": budgets[i]}), range(8)))
        wall = time.perf_counter() - t_start
        unary = grpc_call(stub, "vlm_generate", photos[8], {"messages": prompt, "max_new_tokens": 16})
        launches = {k.name: k.launches for k in all_k}
        instances = {k.name: dict(k.instance_launches) for k in all_k}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        for i, r in enumerate(streams + [unary]):
            if r["code"] or "text_generation" not in r["mime"]:
                raise AssertionError(f"phase 15 (b): request {i} has no TextGenerationV1 final (code {r['code']})")
            if not 1 <= r["body"]["generated_tokens"] <= (budgets + [16])[i]:
                raise AssertionError(f"phase 15 (b): request {i}: {r['body']['generated_tokens']} tokens")
            if i < 8 and b"".join(r["deltas"]).decode() != r["body"]["text"]:
                raise AssertionError(f"phase 15 (b): stream {i}: deltas do not join to the final text")
        missing = [n for n in PHASE15_GRPC_KERNELS if not instances[n].get(hd if n != "flash_attention" else 64)]
        if missing:
            raise AssertionError(f"phase 15 (b): the server never launched {missing} (by head_dim {instances})")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    tokens = sum(r["body"]["generated_tokens"] for r in streams)
    log(f"phase 15 (b) [{card}]: served in {load_s:.2f} s (serve() to the first Health ok); 8 streams in flight, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; vlm_generate {unary['body']['generated_tokens']} "
        f"tokens; peak GiB {peak / 2**30:.3f}; launches {json.dumps(launches)}")
    direct = VLMManager(dir_cfg, dstate, VlmTokenizer.from_model_dir(str(model_dir)), device=device, dtype="bfloat16",
                        gen_slots=8, gen_block=8)
    try:
        r = direct.generate([ChatMessage("user", "describe this photo in one detailed sentence")],
                            vlm_canvas(photos[0], dir_cfg.vision.image_size), max_new_tokens=budgets[0])
        want = direct.tokenizer.decode(r.tokens)
    finally:
        direct.close()
    got0 = streams[0]["body"]
    if (got0["generated_tokens"], got0["text"]) != (len(r.tokens), want):
        raise AssertionError(f"phase 15 (b): request 0 over gRPC differs from the direct manager: "
                             f"{got0['generated_tokens']} tokens {got0['text'][:80]!r} vs {len(r.tokens)} {want[:80]!r}")
    log(f"phase 15 (b): request 0 == a direct VLMManager on the same weights and canvas ({len(r.tokens)} tokens)")
    out.update(grpc_load_s=load_s, grpc_tok_s=tokens / wall, grpc_launches=launches, dir_gib=gib)
    del dstate, direct
    if on_card:
        torch.cuda.empty_cache()

    # -- (c) one MoEFFN layer at full width vs its plain per-expert loop -
    with torch.device("meta"):
        layer = vlm_modeling.MoEFFN(dec)
    layer = vlm_modeling.init_random_(layer.to(bf16).to_empty(device=device), seed + 153)
    x = torch.randn((1, 8, dec.hidden_size), generator=rng, device=device).to(bf16)
    f = dec.moe_intermediate_size
    params = M.MoEParams(layer.router, layer.w_gate, layer.w_up, layer.w_down)

    def plain(x):
        routed = M._moe_exact_local(params, x.reshape(-1, x.shape[-1]), n_experts=dec.moe_experts, k=dec.moe_top_k,
                                    norm_topk=dec.moe_norm_topk, mm=M.grouped_mm_reference).reshape(x.shape)
        return routed + torch.sigmoid(layer.shared_gate(x)) * layer.shared(x)

    with torch.no_grad():
        y = layer(x)
        err = max_err(y, plain(x))
        _, idx = M._topk_gates(x.reshape(-1, dec.hidden_size), layer.router, dec.moe_top_k, dec.moe_norm_topk)
        distinct = int(idx.unique().numel())
        bank = 3 * dec.hidden_size * f * 2  # one expert's three matrices, bf16
        shared = 3 * dec.hidden_size * dec.moe_shared_intermediate * 2
        nb = distinct * bank + shared + dec.hidden_size * (dec.moe_experts + 1) * 2 + 2 * x.numel() * 2
        fl = 2 * 8 * dec.moe_top_k * 3 * dec.hidden_size * f + 2 * 8 * 3 * dec.hidden_size * dec.moe_shared_intermediate
        bms, by = bound(nb, fl, "bfloat16")
        # the grouped product alone: the gate bank over the 32 sorted rows
        xs = x.reshape(-1, dec.hidden_size).repeat_interleave(dec.moe_top_k, 0)
        e_flat = idx.reshape(-1)
        order = torch.sort(e_flat, stable=True).indices
        xs = xs[order].contiguous()
        ends = torch.bincount(e_flat, minlength=dec.moe_experts).cumsum(0).to(torch.int32)
        gms, gby = bound(distinct * dec.hidden_size * f * 2 + xs.numel() * 2 + xs.shape[0] * f * 2,
                         2 * xs.shape[0] * dec.hidden_size * f, "bfloat16")
        if on_card:
            def timed(fn, floor: float) -> tuple[float, str]:
                # device time, or -- when the profiler keeps too few of a
                # library call's events (seen for torch._grouped_mm) -- CUDA
                # events with the launch path, named as such
                ms = device_ms(fn, 50, floor_ms=floor, strict=False)
                return (ms, "on the device") if ms is not None else (cuda_ms(fn, 50), "a call (CUDA events)")

            (ms, ms_how), (gmm, gmm_how) = timed(lambda: layer(x), bms), timed(
                lambda: M.grouped_mm(xs, layer.w_gate, ends), gms)
            row = dict(
                max_abs_err=err, distinct_experts=distinct, ms=ms, ms_how=ms_how,
                # the plain versions read the group bounds on the host (a sync a
                # call): timed with CUDA events, the launch path included
                plain_ms=cuda_ms(lambda: plain(x), 10), bound_ms=bms, bound_by=by,
                grouped_mm_ms=gmm, grouped_mm_how=gmm_how,
                grouped_mm_plain_ms=cuda_ms(lambda: M.grouped_mm_reference(xs, layer.w_gate, ends), 10),
                grouped_mm_bound_ms=gms, grouped_mm_bound_by=gby, syncs=count_syncs(lambda: layer(x)),
            )
            log(f"phase 15 (c) [{card}]: MoEFFN x [1,8,{dec.hidden_size}] bf16 ({distinct} distinct experts of "
                f"{dec.moe_experts}, top-{dec.moe_top_k}, + the shared expert): max|diff| {err:.3e} vs the plain "
                f"per-expert loop (tol {ATOL}+{RTOL}|ref|); layer {row['ms']:.4f} ms {ms_how}, plain "
                f"{row['plain_ms']:.4f} ms a call (CUDA events), bound {bms:.5f} ms ({by}: {nb} B = {distinct} x "
                f"{bank} + shared {shared} + router, x, y at 3.35 TB/s); one grouped product (torch._grouped_mm, "
                f"gate bank, {xs.shape[0]} rows) {row['grouped_mm_ms']:.4f} ms {gmm_how}, its plain loop "
                f"{row['grouped_mm_plain_ms']:.4f} ms a call (CUDA events), bound {gms:.5f} ms ({gby}); "
                f"device-to-host syncs a layer call {row['syncs']}")
            out["layer"] = row
    del layer
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 16's tolerances. Losses of one step from the same state, the card
#: (fp32, TF32 off) against the port on the CPU, or remat against plain:
#: float32 sums in another order, 1e-5 relative. A resumed run's losses
#: against the uninterrupted one's over five steps: 1e-4 relative (the
#: embedding backward's atomics reorder sums, Adam carries the difference).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_RESUME_RTOL = 1e-4
#: the SPMD functions at world size 1 against their plain versions (fp32)
SPMD_TOL = 2e-5
#: phase 16 (d)'s attention shape: the VLM vision tower's [B, H, S, D]
SPMD_SHAPE = (1, 12, 256, 64)


def _train_batch(cfg, n: int, gen, device):
    """``n`` seeded image-text pairs: pixels in [0, 1), ids right-padded
    with 0 after an EOT (the vocabulary's last id, the argmax convention)
    at a seeded length."""
    import torch

    pixels = torch.rand(n, cfg.image_size, cfg.image_size, 3, generator=gen, device=device)
    s = cfg.context_length
    ids = torch.randint(1, cfg.vocab_size - 1, (n, s), generator=gen, device=device)
    lengths = torch.randint(4, s, (n,), generator=gen, device=device)
    pos = torch.arange(s, device=device)[None, :]
    ids = torch.where(pos < lengths[:, None], ids, torch.zeros_like(ids))
    ids = torch.where(pos == lengths[:, None], torch.full_like(ids, cfg.vocab_size - 1), ids)
    return {"pixel_values": pixels, "input_ids": ids}


def _state_equal(a, b) -> bool:
    """Byte equality of two (params, opt_state)-shaped trees of tensors or
    DTensors (read back to the host)."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    a, b = (t.to_local() if isinstance(t, DTensor) else t for t in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool((a.cpu().view(-1).view(torch.uint8)
                                                               == b.cpu().view(-1).view(torch.uint8)).all())


def _cpu_copy(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    return (tree.full_tensor() if isinstance(tree, DTensor) else tree).detach().cpu().clone()


def drive_train(seed: int, card: str, root: Path, cfg=None, device: str = "cuda:0", steps: int = 30,
                batch_size: int = 256, parity_batch: int = 16, spmd_shape=SPMD_SHAPE) -> dict:
    """Phase 16: CLIP training on the port's SPMD layer, in a process group
    of world size 1 (NCCL on the card, gloo on the CPU) with axes
    ``{"data": 1, "model": 1}``. (a) ``ClipTrainer(CLIPConfig())`` in fp32
    with TF32 off: ``steps`` steps on one seeded batch of ``batch_size``
    pairs (``warmup_steps=2``): every loss finite, the last below the
    first, no flash launch (the towers train on the plain attention); the
    rate after warm-up, peak memory, syncs a step. (b) two steps at
    ``parity_batch`` from the same weights on the card and in the port on
    the CPU; one step with ``remat=True`` against (a)'s first. (c) an async
    save at step 10 that returns while it writes, the restored state
    byte-equal to the saved one, a resumed run's steps 11-15 against the
    uninterrupted run's, retention (``max_to_keep=1``). (d) ring and
    Ulysses attention at ``spmd_shape``, causal and not, against
    ``attention_reference``; ``pipeline_apply`` over one stage against
    the plain stage; expert-parallel ``moe_ffn`` against the exact path.
    ``cfg``/``device``/the sizes let the CPU tests rehearse it small."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from lumen_tpu_torch.models.clip.modeling import CLIPConfig
    from lumen_tpu_torch.ops.attention import FLASH, attention_reference
    from lumen_tpu_torch.parallel import (
        MoEParams, init_moe_params, moe_ffn, moe_sharding, pipeline_apply, ring_attention, stage_sharding,
        ulysses_attention,
    )
    from lumen_tpu_torch.parallel.moe import _moe_exact_local, grouped_mm_reference
    from lumen_tpu_torch.runtime.mesh import build_process_mesh
    from lumen_tpu_torch.training import ClipTrainer, TrainCheckpointer, TrainConfig
    from lumen_tpu_torch.training.clip_trainer import learning_rate

    t_phase = time.perf_counter()
    cfg = cfg or CLIPConfig()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(dev)  # the rank's card, before the group and its mesh
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_process_mesh({"data": 1, "model": 1}, device_type=dev.type)
        tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2)
        trainer = ClipTrainer(cfg, tcfg, mesh)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params0, opt0 = trainer.init_state(gen)
        n_params = sum(t.numel() for t in params0.values())
        batch = _train_batch(cfg, batch_size, gen, dev)
        step = trainer.make_train_step()

        def peak_of(fn):
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            res = fn()
            if on_card:
                torch.cuda.synchronize()
            return res, torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0

        # (b) remat: one step from the initial state, its loss and peak
        remat = ClipTrainer(cfg, TrainConfig(learning_rate=1e-4, warmup_steps=2, remat=True), mesh)
        (_, _, m_remat), peak_remat = peak_of(lambda: remat.make_train_step()(params0, opt0, batch))
        loss_remat = float(m_remat["loss"])
        del remat

        # (a) + (c): the run, an async save at step 10
        ckpt = TrainCheckpointer(str(root / "train-ckpt"), max_to_keep=1, async_save=True)
        FLASH.launches = 0
        losses, norms = [], []
        params, opt = params0, opt0
        saved10 = save_return_s = write_s = None
        in_flight = False
        peak_plain = 0.0
        t_rate = None
        for i in range(1, steps + 1):
            if i == 16:
                ckpt.wait()
                if on_card:
                    torch.cuda.synchronize()
                t_rate = time.perf_counter()
            if i == 1:
                (params, opt, m), peak_plain = peak_of(lambda: step(params0, opt0, batch))
            else:
                params, opt, m = step(params, opt, batch)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
            if i == 10:
                saved10 = (params, opt)
                t0 = time.perf_counter()
                ckpt.save(10, params, opt)
                save_return_s = time.perf_counter() - t0
                in_flight = ckpt.in_flight
                if on_card and not in_flight:
                    raise AssertionError("phase 16 (c): the async save at step 10 had finished when it returned")
                t0 = time.perf_counter()
            if i == 15 and saved10 is not None:
                ckpt.wait()
                write_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
        rate_steps = steps - 15
        steps_s = rate_steps / (time.perf_counter() - t_rate)
        flash_launches = FLASH.launches
        losses = [float(x) for x in losses]
        norms = [float(x) for x in norms]
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"phase 16 (a): a loss or norm is not finite: {losses} {norms}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 16 (a): the loss did not fall: {losses[0]:.6f} -> {losses[-1]:.6f}")
        if flash_launches:
            raise AssertionError(f"phase 16 (a): {flash_launches} flash launches in training steps (must be 0)")
        if abs(loss_remat - losses[0]) > TRAIN_LOSS_RTOL * abs(losses[0]):
            raise AssertionError(f"phase 16 (b): remat loss {loss_remat} vs plain {losses[0]}")
        syncs = count_syncs(lambda: step(params, opt, batch)) if on_card else 0

        # (c) restore step 10: byte-equal, then resume 11-15
        _, p10, o10 = ckpt.restore(10, params_like=params0, opt_state_like=opt0)
        if not (_state_equal(p10, saved10[0]) and _state_equal(o10, saved10[1])):
            raise AssertionError("phase 16 (c): the restored step-10 state differs from the saved one")
        resumed = []
        for _ in range(11, 16):
            p10, o10, m = step(p10, o10, batch)
            resumed.append(float(m["loss"]))
        resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[10:15]))
        if resume_err > TRAIN_RESUME_RTOL:
            raise AssertionError(f"phase 16 (c): resumed losses {resumed} vs {losses[10:15]}")
        del p10, o10, saved10
        ckpt.save(steps, params, opt, wait=True)
        kept = ckpt.all_steps()
        if kept != [steps]:
            raise AssertionError(f"phase 16 (c): retention (max_to_keep=1) left {kept}")
        ckpt.close()
        out.update(losses=losses, norms=norms, steps_s=steps_s, pairs_s=steps_s * batch_size,
                   peak_gib=peak_plain, peak_remat_gib=peak_remat, loss_remat=loss_remat, syncs=syncs,
                   flash_launches=flash_launches, params=n_params, save_return_s=save_return_s,
                   write_s=write_s, in_flight=in_flight, resume_err=resume_err, kept=kept)
        del params, opt

        # (b) parity: two steps at parity_batch, the card against the CPU
        small = {k: v[:parity_batch] for k, v in batch.items()}
        p_dev, o_dev = params0, opt0
        cpu = ClipTrainer(cfg, tcfg, device="cpu")
        p_cpu = cpu.place(_cpu_copy(params0))
        o_cpu = cpu.init_opt_state(p_cpu)
        cpu_step = cpu.make_train_step()
        dev_l, cpu_l = [], []
        for _ in range(2):
            p_dev, o_dev, m = step(p_dev, o_dev, small)
            dev_l.append(float(m["loss"]))
            p_cpu, o_cpu, m = cpu_step(p_cpu, o_cpu, {k: v.cpu() for k, v in small.items()})
            cpu_l.append(float(m["loss"]))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(dev_l, cpu_l))
        got = _cpu_copy(p_dev)
        lr = learning_rate(tcfg, 1)  # the one step of the two that moves
        diffs = torch.cat([(got[n] - p_cpu[n]).abs().flatten() for n in got])
        # A first Adam step moves an element by ~lr * sign(g): an element
        # whose gradient is ~0 on one side may flip sign on the other, so
        # the bound is two steps; all but a few elements stay within 1%.
        param_err, share_off = float(diffs.max()), float((diffs > 0.01 * lr).float().mean())
        if loss_err > TRAIN_LOSS_RTOL or param_err > 2 * lr or share_off > 1e-3:
            raise AssertionError(f"phase 16 (b): card vs CPU losses {dev_l} / {cpu_l}, params max|diff| "
                                 f"{param_err:.3e} (bound {2 * lr:.1e}), share over 1% of a step {share_off:.2e}")
        out.update(parity_losses=(dev_l, cpu_l), parity_loss_err=loss_err, parity_param_err=param_err,
                   parity_share_off=share_off, lr=lr)
        del p_dev, o_dev, p_cpu, o_cpu, cpu

        # (d) the SPMD functions at world size 1
        g2 = torch.Generator(device=dev).manual_seed(seed + 16)
        seq_mesh = build_process_mesh({"seq": 1}, device_type=dev.type)
        q, k, v = (torch.randn(*spmd_shape, generator=g2, device=dev) for _ in range(3))
        dq, dk, dv = (distribute_tensor(t, seq_mesh, [Shard(2)]) for t in (q, k, v))
        spmd = {}
        FLASH.launches = 0
        with torch.inference_mode():
            for causal in (False, True):
                ref = attention_reference(q, k, v, causal=causal)
                for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
                    o = fn(dq, dk, dv, seq_mesh, causal=causal).to_local()
                    spmd[f"{name}{' causal' if causal else ''}"] = float((o - ref).abs().max())
        out["ulysses_flash_launches"] = FLASH.launches
        stage_mesh = build_process_mesh({"stage": 1}, device_type=dev.type)
        d = 64
        w = torch.randn(1, d, d, generator=g2, device=dev) * 0.1
        b = torch.randn(1, d, generator=g2, device=dev) * 0.1
        x = torch.randn(32, d, generator=g2, device=dev)
        stacked = {n: distribute_tensor(t, stage_mesh, stage_sharding(stage_mesh)) for n, t in (("w", w), ("b", b))}
        pipe = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), stacked, x, stage_mesh, n_microbatches=4)
        spmd["pipeline"] = float((pipe - torch.tanh(x @ w[0] + b[0])).abs().max())
        ex_mesh = build_process_mesh({"expert": 1}, device_type=dev.type)
        mp = init_moe_params(torch.Generator(device=dev).manual_seed(seed + 17), d, 128, 8)
        xt = torch.randn(64, d, generator=g2, device=dev)
        placed = MoEParams(*(distribute_tensor(t, ex_mesh, pl) for t, pl in zip(mp, moe_sharding(ex_mesh))))
        ep = moe_ffn(placed, distribute_tensor(xt, ex_mesh, [Shard(0)]), ex_mesh, k=2, capacity_factor=None)
        exact = _moe_exact_local(mp, xt, n_experts=8, k=2, norm_topk=True, mm=grouped_mm_reference)
        spmd["moe expert-parallel"] = float((ep.to_local() - exact).abs().max())
        bad = {n: e for n, e in spmd.items() if not e <= SPMD_TOL}
        if bad:
            raise AssertionError(f"phase 16 (d): beyond {SPMD_TOL}: {bad}")
        if on_card and out["ulysses_flash_launches"] != 2:
            raise AssertionError(f"phase 16 (d): Ulysses launched flash {out['ulysses_flash_launches']} times, not 2")
        out["spmd"] = spmd
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        dist.destroy_process_group()
    a = out
    log(f"phase 16 (a): ClipTrainer(CLIPConfig()) {a['params'] / 1e6:.2f}M parameters, fp32 (TF32 off), world 1 "
        f"{{data: 1, model: 1}}: {steps} steps on {batch_size} pairs, loss {a['losses'][0]:.4f} -> "
        f"{a['losses'][-1]:.4f} (grad norm {a['norms'][0]:.3f} -> {a['norms'][-1]:.3f}); steps 16-{steps}: "
        f"{a['steps_s']:.3f} steps/s = {a['pairs_s']:.1f} pairs/s; peak {a['peak_gib']:.3f} GiB (step 1); "
        f"flash launches in the steps {a['flash_launches']}; device-to-host syncs a step {a['syncs']} [{card}]")
    log(f"phase 16 (b): two steps at batch {parity_batch}, card vs CPU: losses {a['parity_losses'][0]} vs "
        f"{a['parity_losses'][1]} (max rel {a['parity_loss_err']:.2e}), params max|diff| {a['parity_param_err']:.3e} "
        f"(a step is ~{a['lr']:.1e}; {a['parity_share_off']:.2e} of elements over 1% of it); remat=True step 1 loss "
        f"{a['loss_remat']:.6f} vs {a['losses'][0]:.6f}, peak {a['peak_remat_gib']:.3f} GiB vs {a['peak_gib']:.3f} [{card}]")
    log(f"phase 16 (c): async save at step 10 returned in {a['save_return_s']:.3f} s (still writing: "
        f"{a['in_flight']}), done {a['write_s']:.3f} s later (after steps 11-15); restored state byte-equal; "
        f"resumed steps 11-15 within {a['resume_err']:.2e} relative; retention kept {a['kept']} [{card}]")
    log(f"phase 16 (d): world 1 max|diff| {json.dumps({n: float(f'{e:.3e}') for n, e in a['spmd'].items()})}; "
        f"Ulysses flash launches {a['ulysses_flash_launches']} [{card}]")
    a["phase_s"] = time.perf_counter() - t_phase
    return a


# -- phase 17: serving over a model axis ------------------------------------------

#: the kernels every rank of phase 17 (b) must launch (the bf16 path), and
#: those of (c) (int8 + speculation under the routing rule)
PHASE17_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
PHASE17_INT8_KERNELS = ("paged_attention_varq",)
#: phase 17 (b): the first decode step's bf16 logits at TP = 2 against TP = 1
TP_LOGIT_COSINE = 0.999
TP_LOGIT_REL = 0.05  # max|diff| / max|TP = 1 logit|
#: phase 17 (d): CLIP embeddings (unit vectors) at TP = 2 against TP = 1
TP_CLIP_COSINE = 0.999
#: phase 17 (f): the group timeout, and the margin a failed call and the
#: Health turn may take past it
TP_DEATH_TIMEOUT_S, TP_DEATH_MARGIN_S = 30.0, 30.0


def tp_yaml(path: Path, cache_dir: Path, vlm_model: str, dtype: str, quantize: str | None = None,
            clip_model: str | None = None, batch_size: int = 8, axes: dict | None = None) -> Path:
    """A deployment whose services carry ``mesh: {axes}`` (default ``{model:
    2}``): ``vlm``, and ``clip`` beside it when ``clip_model`` names one
    (int8 CLIP is W8A8 ``dynamic``)."""
    import yaml

    mesh = {"axes": axes or {"model": 2}}
    services = {"vlm": {
        "enabled": True, "package": "lumen_tpu.models.vlm",
        "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
        "backend_settings": {"dtype": dtype, "batch_size": 8, "mesh": mesh, **({"quantize": quantize} if quantize else {})},
        "models": {"vlm": {"model": vlm_model, "runtime": "jax"}},
    }}
    if clip_model:
        services["clip"] = {
            "enabled": True, "package": "lumen_tpu.models.clip",
            "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
            "backend_settings": {"dtype": dtype, "batch_size": batch_size, "mesh": mesh,
                                 **({"quantize": quantize} if quantize else {})},
            # no label set: its 1,000 embeddings at boot would run the text
            # tower 16 times through the gloo sums (phase 8 holds the labels)
            "models": {"clip": {"model": clip_model, "runtime": "jax"}},
        }
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": sorted(services)},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": services,
    }))
    return path


def boot_tp(yaml_path: Path, device: str, devices: list, backend: str):
    """``serve()`` of a model-axis deployment in process: it starts the
    worker rank itself. Returns the handle, a channel, a stub and the
    seconds to the first ``Health`` ok."""
    import grpc
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t0 = time.perf_counter()
    handle = serve(load_config(str(yaml_path)), port_override=0, skip_download=True, device=device,
                   tp_devices=devices, tp_backend=backend)
    channel = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    stub = InferenceStub(channel)
    stub.Health(empty_pb2.Empty(), timeout=60)
    return handle, channel, stub, time.perf_counter() - t0


def equal_prefix(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def tp_generate(mgr, jobs: list, max_new: int) -> list:
    """Greedy generations of every ``(messages, canvas or None)`` job on
    ``mgr`` at once: token lists."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(lambda job: list(mgr._generate_uncached(
            job[0], job[1], max_new, 0.0, 1.0, False, 1.0, None, True, None).tokens), jobs))


def tp_step_logits(mgr, msgs, canvas, tokens: list, gen=None):
    """The logits that pick each of a greedy run's ``tokens`` after the
    prompt, on the host in float32, ``[len(tokens), V]``: the prompt as one
    prefill chunk (its last position's logits pick ``tokens[0]``), then
    ``tokens[:-1]`` as a second chunk at its end. ``gen`` is the generator
    that runs the chunks (default the manager's); one at another data
    place of a group receives the prepared prompt by value there."""
    import torch

    from lumen_tpu_torch.runtime.tp_group import place_of

    embeds, positions, _, _, _, _, n_live = mgr._prepare_inputs(msgs, canvas)
    gen = gen or mgr.generator
    dev = gen.device
    elsewhere = place_of(gen) is not place_of(mgr.model)
    if elsewhere:
        embeds, positions = embeds.to(dev, copy=True), positions.to(dev, copy=True)
    span = n_live + len(tokens) - 1
    caches = gen.new_prefill_cache(mgr.engine._admit_kv_len(max(int(embeds.shape[1]), span)))
    rows = [gen.prefill_chunk(caches, embeds, positions, 0, torch.tensor([n_live], dtype=torch.int32, device=dev),
                              last_only=True)[0]]
    if len(tokens) > 1:
        prev, _, _ = mgr._prepare_text(torch.tensor([tokens[:-1]], device=mgr.device),
                                       torch.tensor([len(tokens) - 1], device=mgr.device))
        prev = prev.to(dev, copy=True) if elsewhere else prev
        rows.append(gen.prefill_chunk(caches, prev, torch.arange(n_live, span, device=dev)[None], n_live,
                                      torch.tensor([span], dtype=torch.int32, device=dev))[0])
    return torch.cat(rows).float().cpu()


def top2_gap(logits) -> float:
    top = logits.topk(2).values
    return float(top[0] - top[1])


def tp_spill_blocks(mgr, msgs, canvas, blocks: int, resume=None, block: int = 8) -> tuple:
    """One greedy row on ``mgr``'s generator with every page granted up
    front: ``blocks`` decode blocks from the prefill, or from the exported
    row ``resume``; returns the tokens and the row as ``export_row`` gives
    it then."""
    import numpy as np
    import torch

    gen, page = mgr.generator, 16
    pages = -(-gen.max_seq // page)
    pool = gen.init_pool(2, pages=pages + 1, page_size=page)
    tables = np.zeros((2, pages), np.int32)
    tables[0] = np.arange(1, pages + 1)
    dev = gen.device
    rng = torch.Generator(device=dev).manual_seed(0)
    if resume is None:
        embeds, positions, lengths, prompt_ids, _, _, n_live = mgr._prepare_inputs(msgs, canvas)
        params = (torch.zeros(1, device=dev), torch.ones(1, device=dev), torch.zeros(1, dtype=torch.bool, device=dev),
                  torch.ones(1, device=dev))
        caches, tok0, seen = gen.prefill(embeds, positions, lengths, prompt_ids, rng, *params,
                                         kv_len=mgr.engine._admit_kv_len(int(embeds.shape[1])))
        gen.admit(pool, 0, caches, tok0, seen, n_live, tables[0], 256, 0.0, 1.0, False, 1.0)
    else:
        n = len(resume["pages"][0]["k"])
        gen.resume(pool, 0, resume["pages"], tables[0][:n], resume["seen"], resume["cur_tok"], resume["cur_len"],
                   resume["n_gen"], 256, 0.0, 1.0, False, 1.0)
    dev_tables = torch.from_numpy(tables).to(dev)
    toks = [gen.step_block(pool, dev_tables, rng, block)[0].cpu().numpy() for _ in range(blocks)]
    used = -(-int(pool["cur_len"][0]) // page)
    n_pad = 1
    while n_pad < used:
        n_pad *= 2
    ids = np.zeros((n_pad,), np.int32)
    ids[:used] = tables[0][:used]
    return np.concatenate(toks).tolist(), gen.export_row(pool, 0, ids)


def drive_tp(seed: int, card: str, root: Path, vlm_dir: Path, clip_dir: Path, photos: list, device: str = "cuda:0",
             devices: list | None = None, backend: str = "gloo", n_streams: int = 8, n_photos: int = 8,
             max_new: int = 8, spec_new: int = 16, kernels: tuple = PHASE17_KERNELS,
             int8_kernels: tuple = PHASE17_INT8_KERNELS) -> dict:
    """Phase 17: the VLM (``vlm_dir``, phase 6's full-width directory) and
    CLIP (``clip_dir``, phase 8's) served over ``mesh: {model: 2}`` through
    ``serve()``, two ranks on ``devices`` (default: both on ``device``,
    over gloo -- NCCL refuses two ranks on one card), against TP = 1
    managers of the same weights on the same card: (a) fp32 greedy tokens
    of 8 text streams equal, (e) a spilled TP row resumed at TP = 1, (b)
    ``n_photos`` bf16 photo requests: the first step's logits within the
    stated tolerance, the greedy agreement, and where a request parts from
    TP = 1 the TP = 1 top-2 logit gap there against the TP = 2 vs TP = 1
    logit difference at that point (a flip needs one of the two logits to
    move by half the gap: a wider gap is a fault), every rank's launches
    and a clean synchronize, (d) CLIP bf16 and W8A8, (c) int8 with
    speculation (the w8a16 kernel off by the routing rule), (f) a killed
    worker. The TP = 1 references run first: the routing rule is sticky
    for the process. One group (the worker rank started once) serves the
    three ``serve()`` boots, each of which finds it running; ``max_new``
    and ``spec_new`` are the tokens a request (two ranks on one card over
    gloo decode ~5x slower than one rank: PERF.md §6). The CPU tests
    rehearse it small with the launch gates emptied."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    import numpy as np
    import torch
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.models.clip.manager import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.ops import quant_matmul
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.runtime.tp_group import TPGroup, rank_report
    from lumen_tpu_torch.utils.host_decode import vlm_canvas

    t_phase = time.perf_counter()
    devices = devices or [device, device]
    on_card = torch.device(device).type == "cuda"
    question = "describe this photo in one detailed sentence"
    msgs = [ChatMessage("user", question)]
    prompt = json.dumps([{"role": "user", "content": question}])
    templated = [ChatMessage("user", "caption this image : a red car on a wet road , a red car on a wet road .")]
    size = json.loads((vlm_dir / "config.json").read_text())["vision_config"]["image_size"]
    canvases = [vlm_canvas(photos[i], size) for i in range(n_photos)]
    texts = [clip_label(i) for i in range(4)]
    # (a)'s streams are text prompts (the vision tower runs in (b)-(e)):
    # two ranks on one card prefill slowly (PERF.md §6)
    questions = [f"{question} number {i}" for i in range(n_streams)]
    text_jobs = [([ChatMessage("user", q)], None) for q in questions]
    out: dict = {"parts_s": {}}
    laps = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["parts_s"][part], laps[0] = round(now - laps[0], 1), now

    def free() -> None:
        if on_card:
            torch.cuda.empty_cache()

    if not quant_matmul.kernel_routable():
        raise AssertionError("a model axis was noted before phase 17's TP = 1 references")
    with env(LUMEN_CACHE_BYTES="0", LUMEN_VLM_SPEC_K="0"):
        reset_result_cache()
        # -- TP = 1 references on the same card, before any model axis ----------
        ref32 = VLMManager.from_model_dir(str(vlm_dir), device=device, dtype="float32")
        # the worker rank starts while the references run
        pending = ThreadPoolExecutor(max_workers=1)
        starting = pending.submit(TPGroup.spawn, devices, backend, TP_DEATH_TIMEOUT_S)
        want32 = tp_generate(ref32, text_jobs, max_new)
        spill_whole, _ = tp_spill_blocks(ref32, msgs, canvases[0], blocks=3)
        ref16 = VLMManager.from_model_dir(str(vlm_dir), device=device, dtype="bfloat16")
        want16 = tp_generate(ref16, [(msgs, c) for c in canvases], max_new)
        # the logits of every step of the TP = 1 greedy runs: (b) reads
        # the first step's, and each step where a TP = 2 request parts
        logits16 = [tp_step_logits(ref16, msgs, c, w) for c, w in zip(canvases, want16)]
        ref16.close()
        del ref16
        free()
        clip_ref = {}
        for tag, quant in (("bf16", None), ("w8a8", "int8")):
            with env(LUMEN_CLIP_Q8_ROUTE="int8"):
                m = CLIPManager(str(clip_dir), dtype="bfloat16", quantize=quant, device=device)
                m.initialize()
            clip_ref[tag] = (np.stack([m.encode_image(p) for p in photos[:4]]), np.stack([m.encode_text(t) for t in texts]))
            m.close()
            del m
        free()
        with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0", LUMEN_VLM_Q8_ROUTE="int8"):
            ref8 = VLMManager.from_model_dir(str(vlm_dir), device=device, dtype="bfloat16", quantize="int8")
            if on_card:
                quant_matmul.W8A16.zero_counts()
            want8 = tp_generate(ref8, [(templated, c) for c in canvases[:2]], spec_new)
            ref8_launches = quant_matmul.W8A16.launches
            ref8_rate = ref8.engine.spec_accepted / max(ref8.engine.spec_proposed, 1)
            ref8.close()
            del ref8
        free()
        lap("TP = 1 references")
        if on_card:
            torch.cuda.reset_peak_memory_stats()  # rank 0's peaks below are the TP parts'
        group = starting.result()
        pending.shutdown()
        lap("worker rank started")
        try:
            # -- (a) fp32 and (e) spill: serve() on mesh {model: 2} -------------------
            handle, channel, stub, load_s = boot_tp(tp_yaml(root / "tp32.yaml", root / "cache", vlm_dir.name, "float32"),
                                                    device, devices, backend)
            try:
                mgr = handle.services["vlm"].manager
                if mgr.mesh.shape != {"model": 2} or mgr.tp_group is not group:
                    raise AssertionError(f"(a): the VLM service serves on {mgr.mesh.shape}, not on the running group")
                with ThreadPoolExecutor(max_workers=n_streams) as pool:
                    streams = list(pool.map(lambda q: grpc_call(
                        stub, "vlm_generate_stream", b"", {"messages": json.dumps([{"role": "user", "content": q}]),
                                                           "max_new_tokens": max_new}), questions))
                # The stand-in's WordLevel ids decode to distinct words: equal
                # text and count is equal tokens.
                for i, r in enumerate(streams):
                    want_text = ref32.tokenizer.decode(want32[i])
                    if r["code"] or (r["body"]["generated_tokens"], r["body"]["text"]) != (len(want32[i]), want_text):
                        raise AssertionError(f"(a) stream {i} over gRPC at TP = 2 differs from TP = 1: code {r['code']}, "
                                             f"{r.get('body', {}).get('text', '')[:80]!r} vs {want_text[:80]!r}")
                lap("(a) fp32")
                first, row = tp_spill_blocks(mgr, msgs, canvases[0], blocks=2)
                rest, _ = tp_spill_blocks(ref32, msgs, canvases[0], blocks=1, resume=row)
                if first + rest != spill_whole:
                    raise AssertionError(f"(e) a TP row resumed at TP = 1 went on to other tokens: {first + rest} vs "
                                         f"{spill_whole}")
                out["spill_row_mb"] = sum(a["k"].nbytes + a["v"].nbytes for a in row["pages"]) / 1e6
                reports = group.each_rank(rank_report)
                out["a_peak_gib"] = [r.get("peak_gib", 0.0) for r in reports]
                lap("(e) spill")
            finally:
                channel.close()
                handle.stop(grace=1.0)
            out.update(a_load_s=load_s, a_tokens=sum(map(len, want32)), a_streams=len(want32))
            ref32.close()
            free()

            # -- (b) bf16 and (d) CLIP bf16: the serving default ----------------------
            handle, channel, stub, load_s = boot_tp(
                tp_yaml(root / "tp16.yaml", root / "cache", vlm_dir.name, "bfloat16", clip_model=clip_dir.name),
                device, devices, backend)
            try:
                mgr = handle.services["vlm"].manager
                got = tp_step_logits(mgr, msgs, canvases[0], want16[0][:1])[0]
                cos = float(torch.nn.functional.cosine_similarity(got, logits16[0][0], dim=0))
                diff0 = float((got - logits16[0][0]).abs().max())
                rel = diff0 / float(logits16[0][0].abs().max())
                if cos < TP_LOGIT_COSINE or rel > TP_LOGIT_REL:
                    raise AssertionError(f"(b) first-step bf16 logits at TP = 2: cosine {cos:.6f} (>= {TP_LOGIT_COSINE}), "
                                         f"max|diff| {rel:.4f} of max|logit| (<= {TP_LOGIT_REL})")
                group.each_rank(rank_report, True)
                t0 = time.perf_counter()
                got16 = tp_generate(mgr, [(msgs, c) for c in canvases], max_new)
                wall = time.perf_counter() - t0
                reports = group.each_rank(rank_report, True)
                for r, rep in enumerate(reports):
                    missing = [k for k in kernels if rep["launches"][k] == 0]
                    if missing or rep.get("sync", "ok") != "ok":
                        raise AssertionError(f"(b) rank {r}: never launched {missing}, synchronize {rep.get('sync')}")
                prefixes = [equal_prefix(g, w) for g, w in zip(got16, want16)]
                # Where a request parts from TP = 1: the TP = 1 top-2 gap at
                # that step, and how far the TP = 2 logits there lie from it.
                parted = []
                for i, p in enumerate(prefixes):
                    if p == len(want16[i]):
                        continue
                    here = logits16[i][p]
                    diff = float((tp_step_logits(mgr, msgs, canvases[i], want16[i][: p + 1])[p] - here).abs().max())
                    parted.append({"request": i, "token": p, "tp1_gap": top2_gap(here), "max_diff": diff})
                    if parted[-1]["tp1_gap"] > 2 * max(diff, diff0):
                        raise AssertionError(f"(b) request {i} parts from TP = 1 at token {p} where the TP = 1 top-2 gap "
                                             f"{parted[-1]['tp1_gap']:.4f} exceeds twice the TP = 2 logit difference "
                                             f"({diff:.4f} there, {diff0:.4f} at the first step): not a near tie")
                out.update(b_load_s=load_s, b_cos=cos, b_rel=rel, b_prefix=prefixes, b_parted=parted,
                           b_lengths=[len(t) for t in want16], b_tok_s=sum(map(len, got16)) / wall,
                           b_launches=[rep["launches"] for rep in reports],
                           b_peak_gib=[rep.get("peak_gib", 0.0) for rep in reports])
                lap("(b) bf16")
                clip = handle.services["clip"].managers["clip"]
                img = np.stack([clip.encode_image(p) for p in photos[:4]])
                txt = np.stack([clip.encode_text(t) for t in texts])
                served = grpc_call(stub, "clip_image_embed", photos[0], {})
                if served["code"]:
                    raise AssertionError(f"(d) clip_image_embed over gRPC at TP = 2: code {served['code']}")
                out["d_bf16_cos"] = [float(cosines(img, clip_ref["bf16"][0]).min()), float(cosines(txt, clip_ref["bf16"][1]).min())]
                if min(out["d_bf16_cos"]) < TP_CLIP_COSINE:
                    raise AssertionError(f"(d) CLIP bf16 at TP = 2: cosine to TP = 1 {out['d_bf16_cos']} (>= {TP_CLIP_COSINE})")
                lap("(d) CLIP bf16")
            finally:
                channel.close()
                handle.stop(grace=1.0)
            free()

            # -- (c) int8 + speculation, (d) CLIP W8A8, (f) a killed worker -----------
            with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0", LUMEN_VLM_Q8_ROUTE="int8",
                     LUMEN_CLIP_Q8_ROUTE="int8"):
                handle, channel, stub, load_s = boot_tp(
                    tp_yaml(root / "tp8.yaml", root / "cache", vlm_dir.name, "bfloat16", "int8", clip_model=clip_dir.name),
                    device, devices, backend)
            try:
                mgr = handle.services["vlm"].manager
                eng = mgr.engine
                group.each_rank(rank_report, True)
                got8 = tp_generate(mgr, [(templated, c) for c in canvases[:2]], spec_new)
                reports = group.each_rank(rank_report, True)
                for r, rep in enumerate(reports):
                    missing = [k for k in int8_kernels if rep["launches"][k] == 0]
                    if missing or rep["launches"]["w8a16_matmul"] or rep.get("sync", "ok") != "ok":
                        raise AssertionError(f"(c) rank {r}: never launched {missing}; w8a16 launches "
                                             f"{rep['launches']['w8a16_matmul']} (the routing rule wants 0); synchronize "
                                             f"{rep.get('sync')}")
                if on_card and not ref8_launches:
                    raise AssertionError("(c) the TP = 1 int8 reference never launched the w8a16 kernel")
                out.update(c_load_s=load_s, c_prefix=[equal_prefix(got8[i], want8[i]) for i in range(len(got8))],
                           c_lengths=[len(t) for t in want8], c_rate=eng.spec_accepted / max(eng.spec_proposed, 1),
                           c_ref_rate=ref8_rate, c_ref_w8a16=ref8_launches, c_launches=[rep["launches"] for rep in reports],
                           c_peak_gib=[rep.get("peak_gib", 0.0) for rep in reports])
                lap("(c) int8 + spec")
                clip = handle.services["clip"].managers["clip"]
                img = np.stack([clip.encode_image(p) for p in photos[:4]])
                txt = np.stack([clip.encode_text(t) for t in texts])
                out["d_w8a8_cos"] = [float(cosines(img, clip_ref["w8a8"][0]).min()), float(cosines(txt, clip_ref["w8a8"][1]).min())]
                if clip.quant_route != "int8" or min(out["d_w8a8_cos"]) < TP_CLIP_COSINE:
                    raise AssertionError(f"(d) CLIP W8A8 at TP = 2 ({clip.quant_route}): cosine to TP = 1 "
                                         f"{out['d_w8a8_cos']} (>= {TP_CLIP_COSINE})")
                lap("(d) CLIP W8A8")
                # (f): kill the worker rank; the next request fails and Health turns
                os.kill(group.pids[1], signal.SIGKILL)
                t0 = time.perf_counter()
                r = grpc_call(stub, "vlm_generate_stream", photos[0], {"messages": prompt, "max_new_tokens": max_new},
                              timeout=TP_DEATH_TIMEOUT_S + TP_DEATH_MARGIN_S)
                fail_s = time.perf_counter() - t0
                try:
                    stub.Health(empty_pb2.Empty(), timeout=TP_DEATH_TIMEOUT_S)
                    health = "ok"
                except grpc.RpcError as e:
                    health = e.code().name
                health_s = time.perf_counter() - t0
                if not r["code"] or health == "ok" or health_s > TP_DEATH_TIMEOUT_S + TP_DEATH_MARGIN_S:
                    raise AssertionError(f"(f) after the worker was killed: request code {r['code']}, Health {health} "
                                         f"after {health_s:.1f} s")
                out.update(f_code=r["code"], f_fail_s=fail_s, f_health=health, f_health_s=health_s)
                lap("(f) killed worker")
            finally:
                channel.close()
                handle.stop(grace=1.0)
        finally:
            group.stop()
        reset_result_cache()
    free()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


PHASE18_KERNELS = PHASE17_KERNELS
PHASE18_INT8_KERNELS = PHASE5_KERNELS


def rank_readouts(reports: list) -> dict:
    """Each rank's launches by kernel, by kernel and head_dim, and peak
    device memory, from ``rank_report``s."""
    return {"launches": [r["launches"] for r in reports], "instances": [r["instances"] for r in reports],
            "peak_gib": [r.get("peak_gib", 0.0) for r in reports]}


def drive_ep(seed: int, card: str, root: Path, moe_dir: Path | None = None, dir_cfg=None, device: str = "cuda:0",
             backend: str = "gloo", n_photos: int = 8, n_both: int = 2, max_new: int = 8, spec_new: int = 16,
             kernels: tuple = PHASE18_KERNELS, int8_kernels: tuple = PHASE18_INT8_KERNELS) -> dict:
    """Phase 18: the Qwen2-MoE VLM of phase 15 (b) (``moe_dir``:
    Qwen1.5-MoE-A2.7B's widths cut to 2 layers; written here when phase 15
    did not run) served over an ``expert`` axis and a ``model`` axis by
    ``serve()``, the ranks sharing the card over gloo (NCCL refuses two
    ranks on one card), against mesh-less managers of the same directory on
    the same card. (a) ``mesh: {expert: 2}`` in bf16, two ranks of 30
    experts each: the first step's logits within the stated tolerance,
    ``n_photos`` greedy photo requests, where one parts from the mesh-less
    run the mesh-less top-2 logit gap there against the two runs' logit
    difference (phase 17 (b)'s rule: a gap wider than twice it is a
    fault), one request over gRPC; (b) ``{expert: 2}`` with int8 and
    speculation K = 4 on 2 templated requests: every rank launches the
    w8a16 kernel and the verify window (the routing rule keys on the
    model axis alone); (c) ``{expert: 2, model: 2}`` in bf16 on four
    ranks, ``n_both`` requests held to (a)'s rule, w8a16 0 (a bf16
    decoder). Each part reads every rank's launches, peak memory and a
    clean synchronize. The mesh-less references run first. ``dir_cfg``
    and ``device`` let the CPU tests rehearse it small (with the launch
    gates emptied)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.ops import quant_matmul
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.runtime.tp_group import TPGroup, rank_report
    from lumen_tpu_torch.testing.vlm_standins import qwen15_moe_a27b, seeded_state, write_model_dir
    from lumen_tpu_torch.utils.host_decode import vlm_canvas

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    out: dict = {"parts_s": {}}
    laps = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["parts_s"][part], laps[0] = round(now - laps[0], 1), now

    def free() -> None:
        if on_card:
            torch.cuda.empty_cache()

    if moe_dir is None or not (moe_dir / "model.safetensors").exists():
        dir_cfg = dir_cfg or qwen15_moe_a27b(layers=2)
        dstate = seeded_state(dir_cfg, seed + 152, device, torch.bfloat16)
        moe_dir = write_model_dir(root / "cache", "SmokeMoE", dir_cfg, dstate)
        del dstate
        free()
        lap("model directory written")
    cfg = vlm_config_of(moe_dir)
    experts = cfg.decoder.moe_experts
    question = "describe this photo in one detailed sentence"
    msgs = [ChatMessage("user", question)]
    templated = [ChatMessage("user", "caption this image : a red car on a wet road , a red car on a wet road .")]
    photos = [photo_jpeg(seed * 100 + 180 + i) for i in range(n_photos)]
    canvases = [vlm_canvas(p, cfg.vision.image_size) for p in photos]

    def ranks_ran(reports: list, names: tuple, part: str, zero: tuple = ()) -> None:
        for r, rep in enumerate(reports):
            missing = [k for k in names if rep["launches"][k] == 0]
            extra = {k: rep["launches"][k] for k in zero if rep["launches"][k]}
            if missing or extra or rep.get("sync", "ok") != "ok":
                raise AssertionError(f"phase 18 {part} rank {r}: never launched {missing}, launched {extra} (0 wanted), "
                                     f"synchronize {rep.get('sync')}")

    def held(group, mgr, want: list, logits: list, n: int, part: str) -> dict:
        """The first step's logits, then ``n`` greedy requests on ``group``
        against the mesh-less ones (phase 17 (b)'s gap rule where one
        parts)."""
        got0 = tp_step_logits(mgr, msgs, canvases[0], want[0][:1])[0]
        cos = float(torch.nn.functional.cosine_similarity(got0, logits[0][0], dim=0))
        diff0 = float((got0 - logits[0][0]).abs().max())
        rel = diff0 / float(logits[0][0].abs().max())
        if cos < TP_LOGIT_COSINE or rel > TP_LOGIT_REL:
            raise AssertionError(f"phase 18 {part} first-step bf16 logits: cosine {cos:.6f} (>= {TP_LOGIT_COSINE}), "
                                 f"max|diff| {rel:.4f} of max|logit| (<= {TP_LOGIT_REL})")
        group.each_rank(rank_report, True)
        t0 = time.perf_counter()
        got = tp_generate(mgr, [(msgs, c) for c in canvases[:n]], max_new)
        wall = time.perf_counter() - t0
        reports = group.each_rank(rank_report, True)
        prefixes = [equal_prefix(g, w) for g, w in zip(got, want)]
        parted = []
        for i, p in enumerate(prefixes):
            if p == len(want[i]):
                continue
            here = logits[i][p]
            diff = float((tp_step_logits(mgr, msgs, canvases[i], want[i][: p + 1])[p] - here).abs().max())
            parted.append({"request": i, "token": p, "gap": top2_gap(here), "max_diff": diff})
            if parted[-1]["gap"] > 2 * max(diff, diff0):
                raise AssertionError(f"phase 18 {part} request {i} parts from the mesh-less run at token {p} where its "
                                     f"top-2 gap {parted[-1]['gap']:.4f} exceeds twice the logit difference ({diff:.4f} "
                                     f"there, {diff0:.4f} at the first step): not a near tie")
        return dict(cos=cos, rel=rel, diff=diff0, prefix=prefixes, parted=parted, lengths=[len(t) for t in want[:n]],
                    tok_s=sum(map(len, got)) / wall, reports=reports, got=got)

    if not quant_matmul.kernel_routable():
        raise AssertionError("a model axis was noted before phase 18's mesh-less references")
    with env(LUMEN_CACHE_BYTES="0", LUMEN_VLM_SPEC_K="0"):
        reset_result_cache()
        # -- mesh-less references on the same card ----------------------------
        pending = ThreadPoolExecutor(max_workers=1)
        starting = pending.submit(TPGroup.spawn, [device] * 2, backend, TP_DEATH_TIMEOUT_S, 2)
        ref16 = VLMManager.from_model_dir(str(moe_dir), device=device, dtype="bfloat16")
        want16 = tp_generate(ref16, [(msgs, c) for c in canvases], max_new)
        logits16 = [tp_step_logits(ref16, msgs, c, w) for c, w in zip(canvases, want16)]
        ref16.close()
        del ref16
        free()
        with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0", LUMEN_VLM_Q8_ROUTE="int8"):
            ref8 = VLMManager.from_model_dir(str(moe_dir), device=device, dtype="bfloat16", quantize="int8")
            want8 = tp_generate(ref8, [(templated, c) for c in canvases[:2]], spec_new)
            ref8_rate = ref8.engine.spec_accepted / max(ref8.engine.spec_proposed, 1)
            ref8.close()
            del ref8
        free()
        lap("mesh-less references")
        if on_card:
            torch.cuda.reset_peak_memory_stats()  # rank 0's peaks below are the parts'
        group = starting.result()
        pending.shutdown()
        lap("expert-axis worker started")
        try:
            # -- (a) {expert: 2} in bf16 -------------------------------------------
            handle, channel, stub, load_s = boot_tp(
                tp_yaml(root / "ep16.yaml", root / "cache", moe_dir.name, "bfloat16", axes={"expert": 2}),
                device, [device] * 2, backend)
            try:
                mgr = handle.services["vlm"].manager
                banks = mgr.model.decoder.layers[0].mlp.w_gate.shape[0]
                if mgr.mesh.shape != {"expert": 2} or mgr.tp_group is not group or banks * 2 != experts:
                    raise AssertionError(f"phase 18 (a): the VLM serves on {mgr.mesh.shape} with {banks} experts a rank, "
                                         "not on the running group's expert axis")
                a = held(group, mgr, want16, logits16, n_photos, "(a)")
                ranks_ran(a["reports"], kernels, "(a)")
                served = grpc_call(stub, "vlm_generate_stream", photos[0], {
                    "messages": json.dumps([{"role": "user", "content": question}]), "max_new_tokens": max_new})
                text = mgr.tokenizer.decode(a["got"][0])
                if served["code"] or served["body"]["text"] != text:
                    raise AssertionError(f"phase 18 (a): request 0 over gRPC ({served['code']}) "
                                         f"{served.get('body', {}).get('text', '')[:80]!r} vs the manager's {text[:80]!r}")
            finally:
                channel.close()
                handle.stop(grace=1.0)
            out["a"] = {k: v for k, v in a.items() if k not in ("reports", "got")}
            out["a"].update(load_s=load_s, experts_a_rank=banks, **rank_readouts(a["reports"]))
            free()
            lap("(a) expert 2, bf16")

            # -- (b) {expert: 2}, int8 + speculation ---------------------------------
            with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0", LUMEN_VLM_Q8_ROUTE="int8"):
                handle, channel, stub, load_s = boot_tp(
                    tp_yaml(root / "ep8.yaml", root / "cache", moe_dir.name, "bfloat16", "int8", axes={"expert": 2}),
                    device, [device] * 2, backend)
            try:
                mgr = handle.services["vlm"].manager
                group.each_rank(rank_report, True)
                got8 = tp_generate(mgr, [(templated, c) for c in canvases[:2]], spec_new)
                reports = group.each_rank(rank_report, True)
                ranks_ran(reports, int8_kernels, "(b)")
                eng = mgr.engine
                out["b"] = dict(load_s=load_s, prefix=[equal_prefix(g, w) for g, w in zip(got8, want8)],
                                lengths=[len(t) for t in want8], rate=eng.spec_accepted / max(eng.spec_proposed, 1),
                                ref_rate=ref8_rate, **rank_readouts(reports))
            finally:
                channel.close()
                handle.stop(grace=1.0)
            free()
            lap("(b) expert 2, int8 + spec")
        finally:
            group.stop()

        # -- (c) {expert: 2, model: 2} in bf16 on four ranks ----------------------
        group = TPGroup.spawn([device] * 4, backend, TP_DEATH_TIMEOUT_S, 2)
        lap("four ranks started")
        try:
            handle, channel, stub, load_s = boot_tp(
                tp_yaml(root / "eptp16.yaml", root / "cache", moe_dir.name, "bfloat16", axes={"expert": 2, "model": 2}),
                device, [device] * 4, backend)
            try:
                mgr = handle.services["vlm"].manager
                if mgr.mesh.shape != {"expert": 2, "model": 2} or mgr.tp_group is not group:
                    raise AssertionError(f"phase 18 (c): the VLM serves on {mgr.mesh.shape}, not on the running group")
                c = held(group, mgr, want16, logits16, n_both, "(c)")
                ranks_ran(c["reports"], kernels, "(c)", zero=("w8a16_matmul",))
            finally:
                channel.close()
                handle.stop(grace=1.0)
            out["c"] = {k: v for k, v in c.items() if k not in ("reports", "got")}
            out["c"].update(load_s=load_s, **rank_readouts(c["reports"]))
            lap("(c) expert 2 x model 2, bf16")
        finally:
            group.stop()
        reset_result_cache()
    free()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 19: a data axis over one card named twice -------------------------------------

#: phase 19's bound, stated before its first run: an embedding served over
#: {"data": 2} against the mesh-less manager's of the same photo (bf16
#: towers; the split gives the GEMMs and the flash plan 32 rows, not 64)
DATA_COSINE = 0.9999
#: the kernels phase 19 must launch: both CLIP towers' attention on every place
PHASE19_KERNELS = ("flash_attention",)
#: the flash calls of one place's part of the bulk batch of 64 at {"data": 2}
DATA_FLASH_SHAPES = {"CLIP vision, a place's part": (32, 12, 50, False),
                     "CLIP text, causal, a place's part": (32, 8, 77, True)}


def drive_data(seed: int, card: str, root: Path, device: str = "cuda:0", n_photos: int = 128, in_flight: int = 64,
               batch_size: int = 64, n_ingest: int = 64, face_batch: int = 16) -> dict:
    """Phase 19: a ``data`` axis of two places on the one card, named twice
    (``build_mesh({"data": 2}, devices=[card, card])``; no copy between
    cards, and the places share one host's cores). (a) Phase 8's ViT-B/32
    directory behind ``CLIPManager`` over the axis and mesh-less on the
    same card: 16 JPEGs through the decode pool, then ``n_photos`` JPEGs
    decoded on the host first and sent as pixels (``encode_image_tensor``,
    the ``tensor/raw`` path: the batches fill, so a place's part is the
    bulk batch's half) at ``batch_size`` with ``in_flight`` at once through
    each: embeddings within ``DATA_COSINE``, top-1 labels equal but at near
    ties, the flash kernel launched exactly twice as often a batch (a call
    a place a layer), images/s and the memory of one copy and of two. (b)
    The photo ingest (CLIP and phase 9's ``buffalo_l`` face stages, IEEE
    float32 convolutions) of ``n_ingest`` of phase 9's square photos with
    bright discs over the axis and mesh-less: records alike (embeddings
    within ``DATA_COSINE``, faces one to one as phase 11 holds them),
    device-to-host syncs a batch (one a place), images/s. (c)
    ``flash_attention`` at one place's shapes (``DATA_FLASH_SHAPES``)
    against its plain version, timed, is phase 2's. The sizes let the CPU
    tests rehearse it small."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.face import FaceManager
    from lumen_tpu_torch.pipeline.photo import PhotoIngestPipeline
    from lumen_tpu_torch.runtime.mesh import build_mesh
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    places = [dev, dev]
    flash = next(k for k in all_kernels() if k.name == "flash_attention")
    models = root / "cache" / "models"
    log(f"phase 19: a data axis of 2 places on one card named twice ({[str(d) for d in places]}): no copy between "
        f"cards, and the places share one host's cores; phase 8's CLIP and phase 9's face pack [{card}]")
    photos = photo_batch(seed * 100 + 19, n_photos + 16)
    cold, photos = photos[n_photos:], photos[:n_photos]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        size = json.loads((models / "SmokeCLIP" / "config.json").read_text())["vision_config"]["image_size"]
        pixels = list(ex.map(lambda p: _spec_clip_resize(p, {"size": size}), photos))
    log(f"phase 19: {n_photos} JPEGs decoded to {size}x{size} on the host in {time.perf_counter() - t0:.2f} s "
        f"(8 threads)")
    runs: dict = {}
    managers: list = []
    out: dict = {}

    def memory() -> int:
        return torch.cuda.memory_allocated(dev) if on_card else 0

    # The result cache off: the two managers share a namespace, and every
    # answer must be computed. CLIP's batching window fixed at 50 ms: the
    # round's 64 requests in flight fill the bulk batch before it closes
    # (at 5 ms, half of them did), so a place's part is the shape (c) times.
    with env(LUMEN_CACHE_BYTES="0", LUMEN_BATCH_ADAPTIVE="0"):
        reset_result_cache()
        try:
            # -- (a) CLIP over the axis and mesh-less -----------------------------
            for tag, kw in (("mesh-less", {"devices": [dev]}), ("data 2", {"mesh_axes": {"data": 2}, "devices": places})):
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                held0, t0 = memory(), time.perf_counter()
                mgr = CLIPManager(str(models / "SmokeCLIP"), dataset="Smoke1k", dtype="bfloat16",
                                  batch_size=batch_size, max_batch_latency_ms=50.0, warmup=True, device=device, **kw)
                managers.append(mgr)
                mgr.initialize()
                run = {"mgr": mgr, "load_s": time.perf_counter() - t0, "held_gib": (memory() - held0) / 2**30}
                ib = mgr._image_batcher
                with ThreadPoolExecutor(16) as ex:  # through the decode pool, whose workers start
                    run["cold"] = np.stack(list(ex.map(mgr.encode_image, cold)))
                before = dict(ib.stats)
                flash.launches = 0
                t0 = time.perf_counter()
                with ThreadPoolExecutor(in_flight) as ex:
                    run["vecs"] = np.stack(list(ex.map(mgr.encode_image_tensor, pixels)))
                wall = time.perf_counter() - t0
                run.update(launches=flash.launches, batches=ib.stats["batches"] - before["batches"],
                           items=ib.stats["items"] - before["items"], images_s=n_photos / wall,
                           peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0)
                run["fill"] = run["items"] / max(run["batches"] * ib.buckets[-1], 1)
                runs[tag] = run
                log(f"phase 19 (a) {tag}: {mgr.mesh}, buckets {ib.buckets}, up in {run['load_s']:.2f} s holding "
                    f"{run['held_gib']:.3f} GiB; {n_photos} photos at {in_flight} in flight in {wall:.3f} s = "
                    f"{run['images_s']:.1f} images/s, {run['batches']} batches (mean fill {100 * run['fill']:.1f}%), "
                    f"flash_attention launches {run['launches']}, peak {run['peak_gib']:.3f} GiB [{card}]")
            plain, split = runs["mesh-less"], runs["data 2"]
            if len({id(m) for m in split["mgr"].place_models}) != 2:
                raise AssertionError("phase 19 (a): the two places do not hold a copy each")
            if on_card:
                # Each part is copied from a view of the pinned staging
                # buffer: pinned too, so its copy is asynchronous.
                ib = split["mgr"]._image_batcher
                staged = [b for ring in ib._arenas.values() for bufs in ring for b in bufs]
                if not staged or not all(b.is_pinned() and b[len(b) // 2:].is_pinned() for b in staged) \
                        or len(ib._d2h_streams) != 2:
                    raise AssertionError("phase 19 (a): the image batcher staged without pinned memory, or fetched "
                                         "without a side stream a place")
            cos = cosines(np.concatenate([split["vecs"], split["cold"]]), np.concatenate([plain["vecs"], plain["cold"]]))
            diff = float(np.abs(split["vecs"] - plain["vecs"]).max())
            if cos.min() < DATA_COSINE:
                raise AssertionError(f"phase 19 (a): cosine to the mesh-less run {cos.min():.6f} < {DATA_COSINE}")
            layers = plain["mgr"].cfg.vision.layers
            per_batch = {tag: r["launches"] / max(r["batches"], 1) for tag, r in runs.items()}
            for name in PHASE19_KERNELS:
                if plain["launches"] != layers * plain["batches"] or split["launches"] != 2 * layers * split["batches"]:
                    raise AssertionError(f"phase 19 (a): {name} launches {plain['launches']} / {split['launches']} over "
                                         f"{plain['batches']} / {split['batches']} batches, not {layers} and "
                                         f"{2 * layers} a batch")
            # Top-1 labels (the mesh-less label matrix): equal, unless the
            # mesh-less top two lie within 2|split - plain| (phase 8's rule).
            matrix, names = plain["mgr"]._label_matrix, plain["mgr"].label_names
            label_cos = float(cosines(split["mgr"]._label_matrix, matrix).min())
            exact, ties = 0, 0
            for a, b in zip(split["vecs"], plain["vecs"]):
                sims_a, sims_b = matrix @ a, matrix @ b
                top_a, top_b = int(np.argmax(sims_a)), int(np.argmax(sims_b))
                if top_a == top_b:
                    exact += 1
                elif sims_b[top_b] - sims_b[top_a] <= 2 * float(np.linalg.norm(a - b)):
                    ties += 1
                else:
                    raise AssertionError(f"phase 19 (a): top-1 {names[top_a]} vs the mesh-less {names[top_b]}, margin "
                                         f"{sims_b[top_b] - sims_b[top_a]:.5f}")
            if label_cos < DATA_COSINE:
                raise AssertionError(f"phase 19 (a): label embeddings over the axis, cosine {label_cos:.6f}")
            log(f"phase 19 (a): embeddings over {{data: 2}} vs mesh-less (the tensor round and the decode pool's 16): "
                f"cosine min {cos.min():.6f} (bound "
                f"{DATA_COSINE}), max|diff| {diff:.3e}; top-1 labels equal in {exact} of {n_photos}, {ties} near ties; "
                f"label matrix cosine min {label_cos:.6f}; flash launches a batch {json.dumps(per_batch)} ({layers} "
                f"layers); {split['images_s']:.1f} vs {plain['images_s']:.1f} images/s; one copy {plain['held_gib']:.3f} "
                f"GiB, two {split['held_gib']:.3f} GiB [{card}]")
            out.update(images_s=split["images_s"], images_s_plain=plain["images_s"], cos_min=float(cos.min()),
                       max_diff=diff, per_batch=per_batch, launches=split["launches"], labels_exact=exact,
                       label_ties=ties, held_gib=split["held_gib"], held_gib_plain=plain["held_gib"],
                       peak_gib=split["peak_gib"], peak_gib_plain=plain["peak_gib"])

            # -- (b) the photo ingest over the axis and mesh-less -------------------
            items = face_photos(seed * 100 + 19, n_ingest)
            records, stats = {}, {}
            with convolutions_tf32(False):
                for tag, kw in (("mesh-less", {"devices": [dev]}), ("data 2", {"mesh_axes": {"data": 2},
                                                                              "devices": places})):
                    face = FaceManager(str(models / "buffalo_l"), dtype="bfloat16", batch_size=face_batch,
                                       max_batch_latency_ms=2.0, device=device, **kw)
                    managers.append(face)
                    face.initialize()
                    mesh = runs[tag]["mgr"].mesh
                    pipe = PhotoIngestPipeline(mesh, clip=runs[tag]["mgr"], face=face, batch_size=batch_size)
                    list(pipe.run(items[:batch_size]))  # the decode at the ingest's edge and the face batchers warm
                    records[tag] = list(pipe.run(items))
                    stats[tag] = pipe.stats.as_dict()
                    runs[tag]["face"] = face
            face_thr = runs["mesh-less"]["face"].spec.score_threshold
            tally = {"matched": 0, "near": 0, "iou_min": 1.0}
            emb_a = np.stack([r.clip_embedding for r in records["data 2"]])
            emb_b = np.stack([r.clip_embedding for r in records["mesh-less"]])
            cos_b = cosines(emb_a, emb_b)
            if cos_b.min() < DATA_COSINE:
                raise AssertionError(f"phase 19 (b): ingested embeddings vs mesh-less, cosine {cos_b.min():.6f}")
            for i, (a, b) in enumerate(zip(records["data 2"], records["mesh-less"])):
                if a.error or b.error or a.index != b.index:
                    raise AssertionError(f"phase 19 (b): record {i}: {a.error} / {b.error}, index {a.index} / {b.index}")
                t = match_near([{"bbox": f.bbox, "confidence": f.confidence, "embedding": f.embedding} for f in a.faces],
                               [{"bbox": f.bbox, "confidence": f.confidence, "embedding": f.embedding} for f in b.faces],
                               face_thr, TF32_SCORE_TOL, f"phase 19 (b) photo {i} faces", FACE_IOU,
                               lambda g, w: box_iou(g["bbox"], w["bbox"]),
                               lambda g, w: float(np.dot(g["embedding"], w["embedding"])) >= FACE_COSINE)
                tally["matched"] += t["matched"]
                tally["near"] += t["near"]
                tally["iou_min"] = min(tally["iou_min"], t["iou_min"])
            syncs = {tag: st["syncs"] / max(st["batches"], 1) for tag, st in stats.items()}
            if on_card and syncs != {"mesh-less": 1.0, "data 2": 2.0}:
                raise AssertionError(f"phase 19 (b): device-to-host syncs a batch {syncs}, not one a place")
            ingest_s = {tag: n_ingest / st["wall_s"] for tag, st in stats.items()}
            log(f"phase 19 (b): photo ingest (clip + face, IEEE float32 convolutions) of {n_ingest} 1280x1280 photos at batch "
                f"{batch_size}: embeddings cosine min {cos_b.min():.6f}, faces {json.dumps(tally)}; syncs a batch "
                f"{json.dumps(syncs)}; {ingest_s['data 2']:.1f} vs {ingest_s['mesh-less']:.1f} images/s; stats over the "
                f"axis {json.dumps(stats['data 2'])} [{card}]")
            out.update(ingest_s=ingest_s["data 2"], ingest_s_plain=ingest_s["mesh-less"], ingest_cos=float(cos_b.min()),
                       faces=tally, syncs=syncs)
        finally:
            for mgr in managers:
                mgr.close()
            reset_result_cache()

    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 20: the kernels every data place of both ranks must launch in (a)
#: and (b), and those each VLM engine's place must launch in (c)
PHASE20_CLIP_KERNELS = ("flash_attention",)
PHASE20_VLM_KERNELS = ("flash_attention_cache", "paged_attention")
#: phase 20's mesh: two data places over a model axis of two ranks
DP_TP_AXES = {"data": 2, "model": 2}


def dp_tp_yaml(path: Path, cache_dir: Path, clip_model: str, vlm_model: str, batch_size: int) -> Path:
    """Phase 20's deployment: ``clip`` on ``mesh: DP_TP_AXES`` (bf16, the
    bulk batch, a 50 ms window so the round's requests fill it, no label
    set: phase 8 holds the labels) and ``vlm`` on ``mesh: {model: 2}``
    (bf16; its replicas come from ``LUMEN_REPLICAS_VLM``)."""
    import yaml

    def service(kind: str, model: str, axes: dict, **bs) -> dict:
        return {"enabled": True, "package": f"lumen_tpu.models.{kind}",
                "import_info": {"registry_class": f"lumen_tpu.serving.services.{kind}_service."
                                                  f"{'ClipService' if kind == 'clip' else 'VlmService'}"},
                "backend_settings": {"dtype": "bfloat16", "mesh": {"axes": axes}, **bs},
                "models": {kind: {"model": model, "runtime": "jax"}}}

    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": ["clip", "vlm"]},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": {"clip": service("clip", clip_model, DP_TP_AXES, batch_size=batch_size, max_batch_latency_ms=50.0),
                     "vlm": service("vlm", vlm_model, {"model": 2}, batch_size=8)},
    }))
    return path


def place_readouts(reports: list, kernel: str, places: int = 2) -> dict:
    """Each rank's launches of ``kernel`` a data place, and each place's
    peak memory and synchronize, from ``rank_report``s (each of which must
    report ``places`` places)."""
    if any(len(r["places"]) != places for r in reports):
        raise AssertionError(f"a rank reports {[len(r['places']) for r in reports]} data places, not {places} each")
    return {"launches": [[p["launches"][kernel] for p in r["places"]] for r in reports],
            "peak_gib": [[round(p.get("peak_gib", 0.0), 3) for p in r["places"]] for r in reports],
            "sync": [[p.get("sync", "ok") for p in r["places"]] for r in reports]}


def nccl_place_probe(place, x):
    """Phase 20 (d), a program at ``place`` of a group of one rank: ``x``
    goes by value to each rank's device of the place (rank 0 keeps its
    own, moved there); returns its sum over the place's plane (times the
    place's number) on the host and the device it was computed on."""
    import torch.distributed as dist

    y = x.to(place.device).float() * (place.index + 1)
    dist.all_reduce(y, group=place.plane)
    return y.cpu(), str(y.device)


def drive_dp_tp(seed: int, card: str, root: Path, vlm_dir: Path, photos: list, device: str = "cuda:0",
                backend: str = "gloo", n_photos: int = 128, in_flight: int = 64, batch_size: int = 64,
                n_ingest: int = 64, face_batch: int = 16, n_requests: int = 2, max_new: int = 12) -> dict:
    """Phase 20: a ``data`` axis over a ``model`` axis, as two gloo ranks
    sharing the one card, each driving it named twice (two data places of
    the group: four places in all, no NCCL between cards, one host's
    cores), from ``serve()`` of :func:`dp_tp_yaml` on the running group,
    against mesh-less managers on the same card. (a) Phase 8's ViT-B/32
    directory on ``{data: 2, model: 2}``: ``n_photos`` host-decoded pixels
    at ``batch_size`` with ``in_flight`` at once, one gRPC answer,
    embeddings within ``TP_CLIP_COSINE``, top-1 labels (the mesh-less
    label matrix) equal but at near ties, ``flash_attention`` launched a
    vision layer a part on every place of both ranks. (b) The photo ingest
    of ``n_ingest`` of phase 19 (b)'s photos over that CLIP and phase 9's
    face pack on the same mesh (face on rank 0's devices of the places),
    IEEE float32 convolutions: records alike, a device-to-host sync a
    place a batch. (c) Phase 6's directory on ``{model: 2}`` with
    ``LUMEN_REPLICAS_VLM=2``: an engine a place, ``n_requests`` photo
    requests of ``max_new`` greedy tokens on each, the cache and paged
    kernels launched at each engine's place on both ranks, the tokens held
    to the mesh-less run by phase 17 (b)'s rule. (d) NCCL at world size 1
    with its place named twice: a by-value tensor and a sum on each
    place's plane. Every rank and place reports its launches, peak memory
    and a clean synchronize. The sizes let the CPU tests rehearse it small
    (where (d) is skipped)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.face import FaceManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.pipeline.photo import PhotoIngestPipeline
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.runtime.tp_group import TPGroup, place_of, rank_report
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize, vlm_canvas

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ranks = [[dev, dev], [dev, dev]]
    models = root / "cache" / "models"
    log(f"phase 20: {json.dumps(DP_TP_AXES)} as 2 gloo ranks sharing the card, each driving it named twice (4 places, "
        f"no NCCL between cards, one host's cores); phase 8's CLIP, phase 9's face pack, phase 6's VLM [{card}]")
    out: dict = {"parts_s": {}}
    laps = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["parts_s"][part], laps[0] = round(now - laps[0], 1), now

    clip_photos = photo_batch(seed * 100 + 20, n_photos)
    size = json.loads((models / "SmokeCLIP" / "config.json").read_text())["vision_config"]["image_size"]
    with ThreadPoolExecutor(8) as ex:
        pixels = list(ex.map(lambda p: _spec_clip_resize(p, {"size": size}), clip_photos))
    items = face_photos(seed * 100 + 19, n_ingest)  # phase 19 (b)'s photos
    question = "describe this photo in one detailed sentence"
    msgs = [ChatMessage("user", question)]
    vsize = json.loads((vlm_dir / "config.json").read_text())["vision_config"]["image_size"]
    canvases = [vlm_canvas(photos[i % len(photos)], vsize) for i in range(2 * n_requests)]
    jobs = [(msgs, c) for c in canvases]

    def ingest(clip, face) -> tuple:
        pipe = PhotoIngestPipeline(clip.mesh, clip=clip, face=face, batch_size=batch_size)
        list(pipe.run(items[:batch_size]))  # the face batchers warm
        t0 = time.perf_counter()
        records = list(pipe.run(items))
        return records, pipe.stats.as_dict(), n_ingest / (time.perf_counter() - t0)

    # The result cache off (every answer computed), CLIP's window fixed at
    # 50 ms (the round fills the bulk batch), no speculation.
    with env(LUMEN_CACHE_BYTES="0", LUMEN_BATCH_ADAPTIVE="0", LUMEN_VLM_SPEC_K="0"):
        reset_result_cache()
        pending = ThreadPoolExecutor(max_workers=1)
        starting = pending.submit(TPGroup.spawn, ranks, backend, TP_DEATH_TIMEOUT_S)  # beside the references
        pending.shutdown(wait=False)
        group = None
        try:
            # -- mesh-less references on the same card ---------------------------
            ref = CLIPManager(str(models / "SmokeCLIP"), dataset="Smoke1k", dtype="bfloat16", batch_size=batch_size,
                              max_batch_latency_ms=50.0, device=device, devices=[dev])
            ref.initialize()
            face = FaceManager(str(models / "buffalo_l"), dtype="bfloat16", batch_size=face_batch,
                               max_batch_latency_ms=2.0, device=device, devices=[dev])
            face.initialize()
            try:
                t0 = time.perf_counter()
                with ThreadPoolExecutor(in_flight) as ex:
                    ref_vecs = np.stack(list(ex.map(ref.encode_image_tensor, pixels)))
                ref_images_s = n_photos / (time.perf_counter() - t0)
                ref_photo0 = ref.encode_image(clip_photos[0])
                matrix, names = ref._label_matrix, ref.label_names
                with convolutions_tf32(False):
                    ref_records, _, ref_ingest_s = ingest(ref, face)
                face_thr = face.spec.score_threshold
            finally:
                face.close()
                ref.close()
            vlm_ref = VLMManager.from_model_dir(str(vlm_dir), device=device, dtype="bfloat16")
            try:
                want = tp_generate(vlm_ref, jobs, max_new)
                logits = [tp_step_logits(vlm_ref, msgs, c, w) for c, w in zip(canvases, want)]
            finally:
                vlm_ref.close()
            del vlm_ref
            if on_card:
                torch.cuda.empty_cache()
            lap("mesh-less references")
            group = starting.result()
            lap("ranks started")
            with env(LUMEN_REPLICAS_VLM="2"):
                handle, channel, stub, load_s = boot_tp(
                    dp_tp_yaml(root / "dp_tp.yaml", root / "cache", "SmokeCLIP", vlm_dir.name, batch_size), device,
                    [dev] * 4, backend)
            out["load_s"] = load_s
            try:
                clip = handle.services["clip"].managers["clip"]
                vlm = handle.services["vlm"].manager
                if clip.mesh.shape != DP_TP_AXES or clip.tp_group is not group or \
                        [place_of(m).index for m in clip.place_models] != [0, 1]:
                    raise AssertionError(f"(a): CLIP serves on {clip.mesh} with copies at places "
                                         f"{[place_of(m).index for m in clip.place_models]}, not a copy a place of "
                                         f"{DP_TP_AXES} on the running group")
                lap("serve()")

                # -- (a) CLIP over {data: 2, model: 2} -----------------------------
                ib = clip._image_batcher
                before = dict(ib.stats)
                group.each_rank(rank_report, True)
                t0 = time.perf_counter()
                with ThreadPoolExecutor(in_flight) as ex:
                    vecs = np.stack(list(ex.map(clip.encode_image_tensor, pixels)))
                wall = time.perf_counter() - t0
                a = place_readouts(group.each_rank(rank_report, True), "flash_attention")
                batches = ib.stats["batches"] - before["batches"]
                layers = clip.cfg.vision.layers
                for r, row in enumerate(a["launches"]):
                    for d, n in enumerate(row):
                        if PHASE20_CLIP_KERNELS and n != layers * batches:
                            raise AssertionError(f"(a) rank {r} place {d}: flash_attention launched {n} times over "
                                                 f"{batches} batches, not a vision layer a part ({layers * batches})")
                if any(s != "ok" for row in a["sync"] for s in row):
                    raise AssertionError(f"(a): a place did not synchronize clean: {a['sync']}")
                served = grpc_call(stub, "clip_image_embed", clip_photos[0], {})
                if served["code"]:
                    raise AssertionError(f"(a) clip_image_embed over gRPC: code {served['code']}")
                served_vec = np.asarray(served["body"]["vector"], np.float32)
                cos = np.concatenate([cosines(vecs, ref_vecs), cosines(served_vec[None], ref_photo0[None])])
                if cos.min() < TP_CLIP_COSINE:
                    raise AssertionError(f"(a): cosine to the mesh-less run {cos.min():.6f} < {TP_CLIP_COSINE}")
                exact = ties = 0
                for got, ref_vec in zip(vecs, ref_vecs):
                    sims_a, sims_b = matrix @ got, matrix @ ref_vec
                    top_a, top_b = int(np.argmax(sims_a)), int(np.argmax(sims_b))
                    if top_a == top_b:
                        exact += 1
                    elif sims_b[top_b] - sims_b[top_a] <= 2 * float(np.linalg.norm(got - ref_vec)):
                        ties += 1
                    else:
                        raise AssertionError(f"(a): top-1 {names[top_a]} vs the mesh-less {names[top_b]}, margin "
                                             f"{sims_b[top_b] - sims_b[top_a]:.5f}")
                out.update(a_images_s=n_photos / wall, a_images_s_plain=ref_images_s, a_cos=float(cos.min()),
                           a_labels_exact=exact, a_label_ties=ties, a_batches=batches, a_readouts=a,
                           a_per_batch=[[n / max(batches, 1) for n in row] for row in a["launches"]])
                lap("(a) CLIP")

                # -- (b) the photo ingest over that CLIP, and face -------------------
                face = FaceManager(str(models / "buffalo_l"), dtype="bfloat16", batch_size=face_batch,
                                   max_batch_latency_ms=2.0, mesh_axes=DP_TP_AXES, device=device)
                face.initialize()
                try:
                    if [p.index for p in face.mesh.places] != [0, 1] or len(face.det_places) != 2:
                        raise AssertionError(f"(b): face on {face.mesh}, not a copy a place of the group's two")
                    with convolutions_tf32(False):
                        group.each_rank(rank_report, True)
                        records, stats, ingest_s = ingest(clip, face)
                        b = place_readouts(group.each_rank(rank_report, True), "flash_attention")
                finally:
                    face.close()
                emb = np.stack([rec.clip_embedding for rec in records])
                cos_b = cosines(emb, np.stack([rec.clip_embedding for rec in ref_records]))
                if cos_b.min() < TP_CLIP_COSINE:
                    raise AssertionError(f"(b): ingested embeddings vs mesh-less, cosine {cos_b.min():.6f}")
                tally = {"matched": 0, "near": 0, "iou_min": 1.0}
                for i, (x, y) in enumerate(zip(records, ref_records)):
                    if x.error or y.error or x.index != y.index:
                        raise AssertionError(f"(b) record {i}: {x.error} / {y.error}, index {x.index} / {y.index}")
                    t = match_near([{"bbox": f.bbox, "confidence": f.confidence, "embedding": f.embedding} for f in x.faces],
                                   [{"bbox": f.bbox, "confidence": f.confidence, "embedding": f.embedding} for f in y.faces],
                                   face_thr, TF32_SCORE_TOL, f"(b) photo {i} faces", FACE_IOU,
                                   lambda g, w: box_iou(g["bbox"], w["bbox"]),
                                   lambda g, w: float(np.dot(g["embedding"], w["embedding"])) >= FACE_COSINE)
                    for k in ("matched", "near"):
                        tally[k] += t[k]
                    tally["iou_min"] = min(tally["iou_min"], t["iou_min"])
                syncs = stats["syncs"] / max(stats["batches"], 1)
                if on_card and syncs != 2.0:
                    raise AssertionError(f"(b): device-to-host syncs a batch {syncs}, not one a place (2)")
                if PHASE20_CLIP_KERNELS and any(n == 0 for row in b["launches"] for n in row):
                    raise AssertionError(f"(b): a place of a rank launched no flash_attention: {b['launches']}")
                out.update(b_images_s=ingest_s, b_images_s_plain=ref_ingest_s, b_cos=float(cos_b.min()), b_faces=tally,
                           b_syncs=syncs, b_readouts=b)
                lap("(b) ingest")

                # -- (c) the VLM: two replicas of {model: 2}, an engine a place ------
                shapes = [m.shape for m in vlm.fleet_plan.meshes]
                engine_places = [place_of(e.gen).index for e in vlm._engines]
                if shapes != [{"model": 2, "data": 1}] * 2 or engine_places != [0, 1]:
                    raise AssertionError(f"(c): VLM replicas on {shapes} at places {engine_places}, not two "
                                         f"{{model: 2}} replicas a place each")
                group.each_rank(rank_report, True)
                got, t0 = [], time.perf_counter()
                for i, engine in enumerate(vlm._engines):
                    vlm._pick_engine = lambda e=engine: e  # this engine serves its requests
                    try:
                        got += tp_generate(vlm, jobs[i * n_requests:(i + 1) * n_requests], max_new)
                    finally:
                        del vlm._pick_engine
                wall = time.perf_counter() - t0
                reports = group.each_rank(rank_report, True)
                c = {k: place_readouts(reports, k) for k in PHASE20_VLM_KERNELS}
                for k in PHASE20_VLM_KERNELS:
                    if any(n == 0 for row in c[k]["launches"] for n in row):
                        raise AssertionError(f"(c): {k} launched 0 times at an engine's place: {c[k]['launches']}")
                first = []
                for i, engine in enumerate(vlm._engines):  # each engine's first request, its first step
                    j = i * n_requests
                    step = tp_step_logits(vlm, msgs, canvases[j], want[j][:1], gen=engine.gen)[0]
                    cos_c = float(torch.nn.functional.cosine_similarity(step, logits[j][0], dim=0))
                    diff0 = float((step - logits[j][0]).abs().max())
                    first.append({"engine": i, "cos": cos_c, "rel": diff0 / float(logits[j][0].abs().max())})
                    if cos_c < TP_LOGIT_COSINE or first[-1]["rel"] > TP_LOGIT_REL:
                        raise AssertionError(f"(c) engine {i}: first-step logits cosine {cos_c:.6f}, max|diff| "
                                             f"{first[-1]['rel']:.4f} of max|logit|")
                prefixes = [equal_prefix(g, w) for g, w in zip(got, want)]
                parted = []
                for j, p in enumerate(prefixes):
                    if p == len(want[j]):
                        continue
                    engine = vlm._engines[j // n_requests]
                    here = logits[j][p]
                    diff = float((tp_step_logits(vlm, msgs, canvases[j], want[j][: p + 1], gen=engine.gen)[p]
                                  - here).abs().max())
                    parted.append({"request": j, "token": p, "ref_gap": top2_gap(here), "max_diff": diff})
                    if parted[-1]["ref_gap"] > 2 * diff:
                        raise AssertionError(f"(c) request {j} parts from the mesh-less run at token {p} where its "
                                             f"top-2 gap {parted[-1]['ref_gap']:.4f} exceeds twice the logit "
                                             f"difference {diff:.4f}: not a near tie")
                out.update(c_first=first, c_prefix=prefixes, c_lengths=[len(w) for w in want], c_parted=parted,
                           c_tok_s=sum(map(len, got)) / wall, c_readouts=c,
                           c_peak_gib=[r.get("peak_gib", 0.0) for r in reports])
                lap("(c) VLM replicas")
            finally:
                channel.close()
                handle.stop(grace=1.0)
        finally:
            if group is None:
                with contextlib.suppress(Exception):
                    group = starting.result()
            if group is not None:
                group.stop()
        reset_result_cache()

    # -- (d) NCCL at world size 1, its place named twice -------------------------
    if on_card:
        one = TPGroup.spawn([[dev, dev]], "nccl", TP_DEATH_TIMEOUT_S)
        try:
            probes = []
            for d in range(2):
                for x in (torch.arange(4.0), torch.arange(4.0, device=dev)):
                    y, where = one.place(d).run(nccl_place_probe, one.place(d), x)
                    probes.append({"place": d, "from": str(x.device), "on": where, "sum": y.tolist()})
                    if y.tolist() != [v * (d + 1) for v in range(4)] or where != str(dev):
                        raise AssertionError(f"(d) NCCL at world size 1, place {d}: {y.tolist()} on {where}")
        finally:
            one.stop()
        out["d_probes"] = probes
        lap("(d) NCCL")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 21 (a): the kernels the VLM's engines launch at each engine's
#: place on both ranks (the exported tower and the graph CLIP launch none)
PHASE21_VLM_KERNELS = ("flash_attention_cache", "paged_attention")
#: phase 21's mesh: the ``cuda_h100_8_dp_tp`` preset's ``{data: -1, model:
#: 2}`` cut to the two data places of the one card named twice
GRAPH_GROUP_AXES = {"data": 2, "model": 2}


def graph_group_config(cache_dir: Path, clip_model: str, vlm_model: str, device: str = "cuda") -> dict:
    """Phase 21's deployment: the ``clip`` and ``vlm`` blocks of
    ``generate_config("cuda_h100_8_dp_tp", tier="full")`` as the app
    writes them (bf16, the preset's batches and windows), their mesh set
    to ``GRAPH_GROUP_AXES``, their models named, on ``device``, bound to
    the loopback address with no mDNS."""
    from lumen_tpu_torch.app.config_gen import generate_config

    raw = generate_config("cuda_h100_8_dp_tp", tier="full", cache_dir=str(cache_dir)).model_dump(exclude_none=True)
    raw["deployment"]["services"] = ["clip", "vlm"]
    raw["services"] = {name: raw["services"][name] for name in ("clip", "vlm")}
    for name, model in (("clip", clip_model), ("vlm", vlm_model)):
        svc = raw["services"][name]
        svc["backend_settings"]["mesh"]["axes"] = dict(GRAPH_GROUP_AXES)
        svc["backend_settings"]["device"] = device
        svc["models"][name]["model"] = model
    raw["server"].update(host="127.0.0.1", mdns={"enabled": False})
    return raw


def tensor_gib(tree) -> float:
    """GiB of the tensors of a ``{name: tensor}`` dict, or a list of them."""
    items = tree if isinstance(tree, list) else [tree]
    return sum(t.numel() * t.element_size() for d in items for t in d.values()) / 2**30


def drive_graph_group(seed: int, card: str, root: Path, fast_dir: Path, clip_dir: Path, photos: list,
                      device: str = "cuda:0", backend: str = "gloo", n_pixels: int = 64, n_texts: int = 8,
                      n_requests: int = 2, max_new: int = 8) -> dict:
    """Phase 21: exported vision towers beside a ``model`` axis, as the
    ``cuda_h100_8_dp_tp`` preset serves FastVLM-0.5B and MobileCLIP2: one
    ``serve()`` of :func:`graph_group_config` on two gloo ranks sharing the
    card, each driving it named twice (the group's two data places), with
    ``LUMEN_REPLICAS_VLM=2``, against mesh-less managers on the card built
    from the same directories. ``vlm`` serves phase 12 (a)'s FastVLM-style
    directory (``fast_dir``: phase 6's decoder, the FastViTHD stand-in as
    ``onnx/vision_encoder.onnx``), ``clip`` phase 9 (c)'s export-only
    ViT-B/32 towers (``clip_dir``), both linked into a cache of its own. (a) ``n_requests`` greedy requests of
    ``max_new`` tokens on each engine (an engine a place) with photos:
    tokens to phase 17 (b)'s rule, the cache and paged kernels launched at
    each engine's place on both ranks, the tower's weights on rank 0 alone
    (each rank's held and peak memory), and the device-to-host syncs of one
    prepare step on rank 0. (b) ``n_pixels`` pixels through
    ``clip_image_embed`` (one more as a JPEG over gRPC) and ``n_texts``
    ``clip_text_embed`` requests over gRPC: embeddings within
    ``CLIP_COSINE`` of the mesh-less graph CLIP, no program of the group
    run (rank 1 runs no CLIP), one device-to-host copy a place a batch.
    It times nothing. The sizes let the CPU tests rehearse it small."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import yaml

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.runtime import batcher
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.runtime.tp_group import TPGroup, place_of, rank_report
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize, vlm_canvas

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ranks = [[dev, dev], [dev, dev]]
    cache = root / "graph_group"
    cfg = vlm_config_of(fast_dir)
    log(f"phase 21: exported towers beside {json.dumps(GRAPH_GROUP_AXES)}, as 2 gloo ranks sharing the card, each "
        f"driving it named twice (no NCCL between cards, one host's cores); the dp_tp preset's clip and vlm blocks [{card}]")
    out: dict = {"parts_s": {}}
    laps = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["parts_s"][part], laps[0] = round(now - laps[0], 1), now

    (cache / "models").mkdir(parents=True)
    for src in (fast_dir, clip_dir):
        os.symlink(src, cache / "models" / src.name)
    msgs = [ChatMessage("user", "describe this photo in one detailed sentence")]
    canvases = [vlm_canvas(photos[i % len(photos)], cfg.vision.image_size) for i in range(2 * n_requests)]
    jobs = [(msgs, c) for c in canvases]
    clip_photos = photo_batch(seed * 100 + 21, n_pixels + 1)
    texts = [f"a photo of a {clip_label(i)}" for i in range(n_texts)]

    with env(LUMEN_CACHE_BYTES="0", LUMEN_VLM_SPEC_K="0"):
        reset_result_cache()
        pending = ThreadPoolExecutor(max_workers=1)
        starting = pending.submit(TPGroup.spawn, ranks, backend, TP_DEATH_TIMEOUT_S)  # beside the references
        pending.shutdown(wait=False)
        group = None
        try:
            # -- mesh-less references on the same card, from the same directories ----
            vlm_ref = VLMManager.from_model_dir(str(fast_dir), device=device, dtype="bfloat16")
            try:
                if vlm_ref._vision_graph is None:
                    raise AssertionError("phase 21: the mesh-less VLM serves no graph tower")
                want = tp_generate(vlm_ref, jobs, max_new)
                logits = [tp_step_logits(vlm_ref, msgs, c, w) for c, w in zip(canvases, want)]
            finally:
                vlm_ref.close()
            del vlm_ref
            ref = CLIPManager(str(clip_dir), dtype="bfloat16", batch_size=64, device=device, devices=[dev])
            ref.initialize()
            try:
                size = ref.cfg.image_size
                pixels = [_spec_clip_resize(p, {"size": size}) for p in clip_photos[:n_pixels]]
                with ThreadPoolExecutor(n_pixels) as ex:
                    ref_vecs = np.stack(list(ex.map(ref.encode_image_tensor, pixels)))
                ref_photo = ref.encode_image(clip_photos[-1])
                ref_texts = np.stack([ref.encode_text(t) for t in texts])
            finally:
                ref.close()
            del ref  # its towers leave rank 0's device before the held memory is read
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            lap("mesh-less references")
            group = starting.result()
            lap("ranks started")
            config = root / "graph_group.yaml"
            config.write_text(yaml.safe_dump(graph_group_config(cache, clip_dir.name, fast_dir.name, dev.type)))
            with env(LUMEN_REPLICAS_VLM="2"):
                handle, channel, stub, out["load_s"] = boot_tp(config, device, [dev] * 4, backend)
            try:
                vlm = handle.services["vlm"].manager
                clip = handle.services["clip"].managers["clip"]
                shapes = [m.shape for m in vlm.fleet_plan.meshes]
                engine_places = [place_of(e.gen).index for e in vlm._engines]
                if vlm.tp_group is not group or vlm._vision_graph is None or engine_places != [0, 1]:
                    raise AssertionError(f"(a): the VLM serves {'no' if vlm._vision_graph is None else 'a'} graph "
                                         f"tower with engines at places {engine_places} of {shapes}")
                clip_devices = [str(next(iter(m["vision"].values())).device) for m in clip.place_models]
                if clip.mesh.shape != GRAPH_GROUP_AXES or clip.tp_group is not group or \
                        clip_devices != [str(d) for d in clip.mesh.data_devices]:
                    raise AssertionError(f"(b): graph CLIP on {clip.mesh} with copies on {clip_devices}, not on rank "
                                         f"0's device of each place of {GRAPH_GROUP_AXES}")
                # each rank's device memory held by tensors (a program of
                # torch's own function: a worker cannot load this script's)
                held = [b / 2**30 for b in group.each_rank(torch.cuda.memory_allocated)] if on_card else [0.0, 0.0]
                tower_gib, clip_gib = tensor_gib(vlm._vision_params), tensor_gib(
                    [m[t] for m in clip.place_models for t in ("vision", "text")])
                out.update(a_shapes=shapes, held_gib=held, tower_gib=tower_gib, clip_gib=clip_gib)
                if on_card and held[0] - held[1] < 0.95 * (tower_gib + clip_gib):
                    raise AssertionError(f"(a): rank 0 holds {held[0]:.3f} GiB and rank 1 {held[1]:.3f}: the tower "
                                         f"({tower_gib:.3f} GiB) and the graph CLIP ({clip_gib:.3f}) are not rank 0's alone")
                lap("serve()")

                # -- (a) the VLM: two replicas, an engine a place, the tower on rank 0 -----
                group.each_rank(rank_report, True)
                got = []
                for i, engine in enumerate(vlm._engines):
                    vlm._pick_engine = lambda e=engine: e  # this engine serves its requests
                    try:
                        got += tp_generate(vlm, jobs[i * n_requests:(i + 1) * n_requests], max_new)
                    finally:
                        del vlm._pick_engine
                reports = group.each_rank(rank_report, True)
                a = {k: place_readouts(reports, k) for k in PHASE21_VLM_KERNELS}
                for k in PHASE21_VLM_KERNELS:
                    if any(a[k]["launches"][r][i] == 0 for r in range(2) for i in range(2)):
                        raise AssertionError(f"(a): {k} launched 0 times at an engine's place: {a[k]['launches']}")
                first = []
                for i, engine in enumerate(vlm._engines):  # each engine's first request, its first step
                    j = i * n_requests
                    step = tp_step_logits(vlm, msgs, canvases[j], want[j][:1], gen=engine.gen)[0]
                    cos_a = float(torch.nn.functional.cosine_similarity(step, logits[j][0], dim=0))
                    first.append({"engine": i, "cos": cos_a,
                                  "rel": float((step - logits[j][0]).abs().max()) / float(logits[j][0].abs().max())})
                    if cos_a < TP_LOGIT_COSINE or first[-1]["rel"] > TP_LOGIT_REL:
                        raise AssertionError(f"(a) engine {i}: first-step logits cosine {cos_a:.6f}, max|diff| "
                                             f"{first[-1]['rel']:.4f} of max|logit|")
                prefixes = [equal_prefix(g, w) for g, w in zip(got, want)]
                parted = []
                for j, p in enumerate(prefixes):
                    if p == len(want[j]):
                        continue
                    engine = vlm._engines[j // n_requests]
                    here = logits[j][p]
                    diff = float((tp_step_logits(vlm, msgs, canvases[j], want[j][: p + 1], gen=engine.gen)[p]
                                  - here).abs().max())
                    parted.append({"request": j, "token": p, "ref_gap": top2_gap(here), "max_diff": diff})
                    if parted[-1]["ref_gap"] > 2 * diff:
                        raise AssertionError(f"(a) request {j} parts from the mesh-less run at token {p} where its "
                                             f"top-2 gap {parted[-1]['ref_gap']:.4f} exceeds twice the logit "
                                             f"difference {diff:.4f}: not a near tie")
                canvas = torch.from_numpy(canvases[0]).to(dev)
                ids = torch.full((1, 64), cfg.pad_token_id, device=dev)
                ids[0, 0] = cfg.image_token_id
                length = torch.tensor([20], device=dev)
                syncs = count_syncs(lambda: vlm._prepare(canvas[None], ids, length)) if on_card else 0
                out.update(a_first=first, a_prefix=prefixes, a_lengths=[len(w) for w in want], a_parted=parted,
                           a_readouts=a, a_peak_gib=[r.get("peak_gib", 0.0) for r in reports], a_prepare_syncs=syncs)
                lap("(a) VLM")

                # -- (b) graph CLIP: local calls on rank 0's device of each place ---------
                fetches = [0]
                fetch = batcher._fetch_cuda

                def counted(*args, **kw):
                    fetches[0] += 1
                    return fetch(*args, **kw)

                ib, tb = clip._image_batcher, clip._text_batcher
                group.each_rank(rank_report, True)
                before = (ib.stats["batches"], tb.stats["batches"], group.programs)
                batcher._fetch_cuda = counted
                try:
                    with ThreadPoolExecutor(n_pixels) as ex:
                        vecs = np.stack(list(ex.map(clip.encode_image_tensor, pixels)))
                    served = grpc_call(stub, "clip_image_embed", clip_photos[-1], {})
                    with ThreadPoolExecutor(n_texts) as ex:
                        told = list(ex.map(lambda t: grpc_call(stub, "clip_text_embed", t.encode(), {},
                                                               mime="text/plain"), texts))
                finally:
                    batcher._fetch_cuda = fetch
                programs = group.programs - before[2]
                batches = ib.stats["batches"] - before[0] + tb.stats["batches"] - before[1]
                if any(r["code"] for r in [served, *told]):
                    raise AssertionError(f"(b): codes {[r['code'] for r in [served, *told]]}")
                served_vecs = np.stack([np.asarray(r["body"]["vector"], np.float32) for r in [served, *told]])
                cos = np.concatenate([cosines(vecs, ref_vecs),
                                      cosines(served_vecs, np.concatenate([ref_photo[None], ref_texts]))])
                if cos.min() < CLIP_COSINE:
                    raise AssertionError(f"(b): cosine to the mesh-less graph CLIP {cos.min():.6f} < {CLIP_COSINE}")
                if programs:
                    raise AssertionError(f"(b): the group ran {programs} programs for graph CLIP: rank 1 ran CLIP")
                per_batch = fetches[0] / max(batches, 1)
                if on_card and per_batch != len(clip.mesh.places):
                    raise AssertionError(f"(b): {fetches[0]} device-to-host copies over {batches} batches, not one a "
                                         f"place ({len(clip.mesh.places)})")
                # rank 1's programs a place since the zeroing readout: the
                # readout's own program at place 0, and nothing else
                rank1 = [p["programs"] for p in group.each_rank(rank_report)[1]["places"]]
                if rank1 != [1, 0]:
                    raise AssertionError(f"(b): rank 1 ran programs {rank1} a place across (b), not the readout alone")
                out.update(b_cos=float(cos.min()), b_batches=batches, b_fetches_per_batch=per_batch,
                           b_programs=programs, b_rank1_programs=rank1)
                lap("(b) CLIP")
            finally:
                channel.close()
                handle.stop(grace=1.0)
        finally:
            if group is None:
                with contextlib.suppress(Exception):
                    group = starting.result()
            if group is not None:
                group.stop()
        reset_result_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 22 (a): the kernels each of CLIP's two serving places must launch;
#: (b): those the VLM's one place must launch on both ranks
PHASE22_CLIP_KERNELS = ("flash_attention",)
PHASE22_VLM_KERNELS = ("flash_attention_cache", "paged_attention")
#: phase 22's meshes: two data places, each a block of two seq positions of
#: one device (the card named four times), and a model axis beside a seq axis
SEQ_CLIP_AXES = {"data": 2, "seq": 2}
SEQ_VLM_AXES = {"model": 2, "seq": 2}


def drive_seq(seed: int, card: str, root: Path, vlm_dir: Path, photos: list, device: str = "cuda:0",
              backend: str = "gloo", n_photos: int = 64, in_flight: int = 64, batch_size: int = 64,
              n_requests: int = 2, max_new: int = 8) -> dict:
    """Phase 22: ``seq`` axes served as the JAX package serves them, one copy
    a data place (``runtime.mesh``: the JAX package replicates the weights
    over ``seq`` and splits a batch over ``data`` alone). (a) Phase 8's
    ViT-B/32 directory behind ``CLIPManager`` over ``SEQ_CLIP_AXES`` with the
    card named four times, and mesh-less on the same card: ``n_photos``
    host-decoded pixels at ``batch_size`` with ``in_flight`` at once,
    embeddings within ``CLIP_COSINE``, ``flash_attention`` a vision layer a
    part at each of the two serving places (counted by a hook on each
    place's tower), and the weights held by two copies, not four (the idle
    ``seq`` positions hold none: less than 2.5 times the mesh-less copy).
    (b) Phase 6's directory served by ``serve()`` on ``SEQ_VLM_AXES`` as two
    gloo ranks sharing the card, the group's one place a block of two
    ``seq`` positions: ``n_requests`` photo requests of ``max_new`` greedy
    tokens, the cache and paged kernels launched on both ranks, the tokens
    held to a mesh-less manager on the card by phase 17 (b)'s rule, and one
    ``vlm_generate`` over gRPC. The sizes let the CPU tests rehearse it
    small."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.runtime.tp_group import rank_report
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize, vlm_canvas

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    flash = next(k for k in all_kernels() if k.name == "flash_attention")
    models = root / "cache" / "models"
    log(f"phase 22: (a) CLIP on {json.dumps(SEQ_CLIP_AXES)} with the card named four times, (b) the VLM on "
        f"{json.dumps(SEQ_VLM_AXES)} as 2 gloo ranks sharing the card; one copy a data place [{card}]")
    out: dict = {"parts_s": {}}
    laps = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["parts_s"][part], laps[0] = round(now - laps[0], 1), now

    def memory() -> int:
        return torch.cuda.memory_allocated(dev) if on_card else 0

    clip_photos = photo_batch(seed * 100 + 22, n_photos)
    size = json.loads((models / "SmokeCLIP" / "config.json").read_text())["vision_config"]["image_size"]
    with ThreadPoolExecutor(8) as ex:
        pixels = list(ex.map(lambda p: _spec_clip_resize(p, {"size": size}), clip_photos))
    question = "describe this photo in one detailed sentence"
    msgs = [ChatMessage("user", question)]
    vsize = json.loads((vlm_dir / "config.json").read_text())["vision_config"]["image_size"]
    canvases = [vlm_canvas(photos[i % len(photos)], vsize) for i in range(n_requests)]
    jobs = [(msgs, c) for c in canvases]

    # The result cache off (every answer computed), CLIP's window fixed at
    # 50 ms (the round fills the bulk batch), no speculation.
    with env(LUMEN_CACHE_BYTES="0", LUMEN_BATCH_ADAPTIVE="0", LUMEN_VLM_SPEC_K="0"):
        reset_result_cache()
        managers: list = []
        try:
            # -- (a) CLIP over {data: 2, seq: 2} and mesh-less ---------------------
            runs: dict = {}
            for tag, kw in (("mesh-less", {"devices": [dev]}),
                            ("data 2 x seq 2", {"mesh_axes": SEQ_CLIP_AXES, "devices": [dev] * 4})):
                if on_card:
                    torch.cuda.empty_cache()
                held0 = memory()
                mgr = CLIPManager(str(models / "SmokeCLIP"), dataset="Smoke1k", dtype="bfloat16",
                                  batch_size=batch_size, max_batch_latency_ms=50.0, device=device, **kw)
                managers.append(mgr)
                mgr.initialize()
                run = {"mgr": mgr, "held_gib": (memory() - held0) / 2**30, "per_place": [0] * len(mgr.place_models)}
                for i, m in enumerate(mgr.place_models):  # each place's flash launches, by a hook on its tower
                    m.vision.register_forward_pre_hook(lambda mod, args, i=i, r=run: r.__setitem__("mark", flash.launches))
                    m.vision.register_forward_hook(
                        lambda mod, args, res, i=i, r=run: r["per_place"].__setitem__(
                            i, r["per_place"][i] + flash.launches - r["mark"]))
                ib = mgr._image_batcher
                before = dict(ib.stats)
                flash.launches = 0
                t0 = time.perf_counter()
                with ThreadPoolExecutor(in_flight) as ex:
                    run["vecs"] = np.stack(list(ex.map(mgr.encode_image_tensor, pixels)))
                wall = time.perf_counter() - t0
                run.update(launches=flash.launches, batches=ib.stats["batches"] - before["batches"],
                           images_s=n_photos / wall)
                runs[tag] = run
                log(f"phase 22 (a) {tag}: {mgr.mesh}, idle device positions {mgr.mesh.idle_devices}, "
                    f"{len(mgr.place_models)} cop{'y' if len(mgr.place_models) == 1 else 'ies'} holding "
                    f"{run['held_gib']:.3f} GiB; {n_photos} pixels at {in_flight} in flight: {run['images_s']:.1f} "
                    f"images/s, {run['batches']} batches, flash_attention launches {run['launches']} (a place "
                    f"{run['per_place']}) [{card}]")
            plain, seq = runs["mesh-less"], runs["data 2 x seq 2"]
            mesh = seq["mgr"].mesh
            if mesh.shape != SEQ_CLIP_AXES or len(seq["mgr"].place_models) != 2 or \
                    mesh.idle_devices != [1, 3]:
                raise AssertionError(f"(a): CLIP on {mesh} with {len(seq['mgr'].place_models)} copies, idle "
                                     f"{mesh.idle_devices}: not a copy at each data place's first seq position")
            layers = plain["mgr"].cfg.vision.layers
            for name in PHASE22_CLIP_KERNELS:
                if seq["per_place"] != [layers * seq["batches"]] * 2 or seq["launches"] != 2 * layers * seq["batches"]:
                    raise AssertionError(f"(a): {name} launched {seq['per_place']} times at the two places over "
                                         f"{seq['batches']} batches, not a vision layer a part ({layers * seq['batches']})")
            if on_card and seq["held_gib"] >= 2.5 * plain["held_gib"]:
                raise AssertionError(f"(a): {seq['held_gib']:.3f} GiB held against {plain['held_gib']:.3f} GiB for one "
                                     f"copy: the idle seq positions hold weights")
            cos = cosines(seq["vecs"], plain["vecs"])
            if cos.min() < CLIP_COSINE:
                raise AssertionError(f"(a): cosine to the mesh-less run {cos.min():.6f} < {CLIP_COSINE}")
            out.update(a_cos=float(cos.min()), a_per_place=seq["per_place"], a_launches=seq["launches"],
                       a_batches=seq["batches"], a_held_gib=seq["held_gib"], a_held_gib_plain=plain["held_gib"],
                       a_images_s=seq["images_s"], a_images_s_plain=plain["images_s"], a_idle=mesh.idle_devices)
        finally:
            for mgr in managers:
                mgr.close()
        lap("(a) CLIP")

        # -- (b) the VLM on {model: 2, seq: 2}: two ranks sharing the card ---------
        if on_card:
            torch.cuda.empty_cache()
        vlm_ref = VLMManager.from_model_dir(str(vlm_dir), device=device, dtype="bfloat16")
        try:
            want = tp_generate(vlm_ref, jobs, max_new)
            logits = [tp_step_logits(vlm_ref, msgs, c, w) for c, w in zip(canvases, want)]
        finally:
            vlm_ref.close()
        del vlm_ref
        if on_card:
            torch.cuda.empty_cache()
        lap("(b) mesh-less reference")
        handle, channel, stub, load_s = boot_tp(
            tp_yaml(root / "seq.yaml", root / "cache", vlm_dir.name, "bfloat16", axes=SEQ_VLM_AXES), device,
            [dev] * 4, backend)
        try:
            group, vlm = handle.tp_group, handle.services["vlm"].manager
            layout = {"group": group.shape, "block": group.block, "mesh": vlm.mesh.shape,
                      "places": [p.index for p in vlm.mesh.places], "idle": vlm.mesh.idle_devices}
            if layout != {"group": {"data": 1, "expert": 1, "model": 2}, "block": 2, "mesh": SEQ_VLM_AXES,
                          "places": [0], "idle": [2, 3]}:
                raise AssertionError(f"(b): the VLM serves on {layout}, not one {{model: 2}} copy at seq 0")
            lap("(b) serve()")
            group.each_rank(rank_report, True)
            t0 = time.perf_counter()
            got = tp_generate(vlm, jobs, max_new)
            wall = time.perf_counter() - t0
            reports = group.each_rank(rank_report, True)
            b = {k: place_readouts(reports, k, places=1) for k in PHASE22_VLM_KERNELS}
            for k in PHASE22_VLM_KERNELS:
                if any(n == 0 for row in b[k]["launches"] for n in row):
                    raise AssertionError(f"(b): {k} launched 0 times on a rank: {b[k]['launches']}")
            if any(s != "ok" for k in b for row in b[k]["sync"] for s in row):
                raise AssertionError(f"(b): a rank did not synchronize clean: {b}")
            first = []
            for j in range(n_requests):
                step = tp_step_logits(vlm, msgs, canvases[j], want[j][:1])[0]
                cos_b = float(torch.nn.functional.cosine_similarity(step, logits[j][0], dim=0))
                rel = float((step - logits[j][0]).abs().max()) / float(logits[j][0].abs().max())
                first.append({"request": j, "cos": cos_b, "rel": rel})
                if cos_b < TP_LOGIT_COSINE or rel > TP_LOGIT_REL:
                    raise AssertionError(f"(b) request {j}: first-step logits cosine {cos_b:.6f}, max|diff| {rel:.4f} "
                                         f"of max|logit|")
            prefixes = [equal_prefix(g, w) for g, w in zip(got, want)]
            parted = []
            for j, p in enumerate(prefixes):
                if p == len(want[j]):
                    continue
                here = logits[j][p]
                diff = float((tp_step_logits(vlm, msgs, canvases[j], want[j][: p + 1])[p] - here).abs().max())
                parted.append({"request": j, "token": p, "ref_gap": top2_gap(here), "max_diff": diff})
                if parted[-1]["ref_gap"] > 2 * diff:
                    raise AssertionError(f"(b) request {j} parts from the mesh-less run at token {p} where its top-2 "
                                         f"gap {parted[-1]['ref_gap']:.4f} exceeds twice the logit difference "
                                         f"{diff:.4f}: not a near tie")
            served = grpc_call(stub, "vlm_generate", photos[0], {"messages": json.dumps(
                [{"role": "user", "content": question}]), "max_new_tokens": max_new})
            if served["code"] or not served["body"]["text"]:
                raise AssertionError(f"(b) vlm_generate over gRPC: code {served['code']}")
            out.update(load_s=load_s, b_first=first, b_prefix=prefixes, b_lengths=[len(w) for w in want],
                       b_parted=parted, b_tok_s=sum(map(len, got)) / wall, b_readouts=b,
                       b_peak_gib=[r.get("peak_gib", 0.0) for r in reports], b_layout=layout)
            lap("(b) VLM")
        finally:
            channel.close()
            handle.stop(grace=1.0)
        reset_result_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 23: dtype float16 on the card, the MoE decoder in float16 and float32

#: the kernels phase 23 must launch in float16 (at some head_dim) and the
#: dtypes the grouped product must run in
PHASE23_FP16_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention", "paged_attention_varq")
PHASE23_GROUPED_DTYPES = ("float16", "float32")
#: float16 forwards on the kernels against the same model on the plain
#: attention: cosine of the logits (as phase 15's MOE_FORWARD_COSINE)
FP16_FORWARD_COSINE = 0.995


def dtype_launches(kernels) -> dict:
    """Each kernel's launches by element type and head_dim since its counts
    were zeroed: ``{name: {"float16": {64: n}}}``."""
    return {k.name: {dt: dict(by) for dt, by in k.dtype_launches.items()} for k in kernels}


def add_launches(total: dict, more: dict) -> dict:
    for name, by_dtype in more.items():
        for dt, by in by_dtype.items():
            tally = total.setdefault(name, {}).setdefault(dt, {})
            for inst, n in by.items():
                tally[inst] = tally.get(inst, 0) + n
    return total


def forward_check(model, cfg, modeling, seed: int, device, dtype, what: str) -> tuple[float, int]:
    """A VLM's cacheless forward (the models' own entry point) on the
    kernels against the same model on the plain attention, in ``dtype``:
    logit cosine over the entries finite on both sides, and the count of
    entries not finite on either (an overflow of the seeded weights shows
    there, on both paths alike)."""
    import torch

    rng = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(3, 1000, (1, 12), generator=rng, device=device)
    ids[0, 1] = cfg.image_token_id
    pixels = torch.randn((1, cfg.vision.image_size, cfg.vision.image_size, 3), generator=rng, device=device).to(dtype)
    with torch.no_grad():
        got = model(ids, pixels).float()
        with plain_attention(modeling):
            ref = model(ids, pixels).float()
    if got.shape != (1, 12 - 1 + cfg.vision.num_tokens, cfg.decoder.vocab_size):
        raise AssertionError(f"{what}: the cacheless forward gave {tuple(got.shape)}")
    both = torch.isfinite(got) & torch.isfinite(ref)
    if not bool((torch.isfinite(got) == torch.isfinite(ref)).all()):
        raise AssertionError(f"{what}: the kernels and the plain attention overflow at different logits")
    cos = float(cosines(got[both].cpu(), ref[both].cpu())) if bool(both.any()) else float("nan")
    if not cos >= FP16_FORWARD_COSINE:
        raise AssertionError(f"{what}: cacheless forward on the kernels vs the plain attention: cosine {cos:.6f}")
    return cos, int((~both).sum())


def drive_fp16(seed: int, card: str, root: Path, phase6: dict, device: str = "cuda:0", n_captions: int = 4,
               n_streams: int = 2, n_photos: int = 16, n_pages: int = 2, tokens: int = 24, moe_cfg=None) -> dict:
    """Phase 23: ``dtype: float16`` served on the card, and the Qwen2-MoE
    decoder in float16 and float32. (a) one ``serve()`` of ``vlm`` (phase
    6's ``VLMConfig()`` directory, 8 slots, the paged engine with
    ``LUMEN_VLM_SPEC_K=4``), ``clip`` (phase 8's ViT-B/32) and ``ocr``
    (phase 10 (b)'s native DBNet + SVTR, head_dim 16), every block at
    ``dtype: float16``: greedy captions on templated prompts and streams
    with photos, then a sampled caption alone; CLIP pixels as
    ``tensor/raw``, texts and labels; OCR pages. Captions are held equal to
    the manager's rerun alone and the VLM's cacheless float16 forward to
    the plain attention; CLIP embeddings to the manager's towers on the
    plain attention (``CLIP_COSINE``); OCR boxes to the plain path's. (b)
    Qwen1.5-MoE-A2.7B's decoder at full width cut to 2 layers (phase 15
    (b)'s cut) behind the ViT, seeded on the card in float16 and then
    float32: phase 4's drive on the paged engine (float16 with speculation
    K=4 and a sampled request after), the cacheless forward on the kernels
    against the plain attention, and one ``MoEFFN`` layer's device-to-host
    syncs a call in bf16, float16 and float32 (they must be equal), against
    its plain per-expert loop. Every attention kernel must launch in
    float16 and the grouped product in float16 and float32."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import modeling as clip_modeling
    from lumen_tpu_torch.models.ocr import modeling as ocr_modeling
    from lumen_tpu_torch.models.vlm import VLMManager
    from lumen_tpu_torch.models.vlm import modeling as vlm_modeling
    from lumen_tpu_torch.parallel import moe as M
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.testing.vlm_standins import qwen15_moe_a27b, seeded_state
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    f16 = torch.float16
    kernels = all_kernels() + moe_kernels()
    out: dict = {"launches": {}}

    def zero() -> None:
        for k in kernels:
            k.zero_counts()

    # -- (a) the float16 tier -------------------------------------------------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    vlm_cfg = vlm_config_of(phase6["model_dir"])
    settings = {"dtype": "float16", "batch_size": 8}
    tier = {"vlm": ("SmokeVLM", {**settings, "batch_buckets": [64, 128, 256, 512, 1024]}),
            "clip": ("SmokeCLIP", {**settings, "batch_size": 64}),
            "ocr": ("SmokeOCR", {**settings, "batch_buckets": [320, 640, 960]})}
    photos = phase6["photos"][:n_captions + n_streams + 1]
    pages = ocr_pages(seed * 100 + 23, n_pages)
    texts = [f"a photo of {w}" for w in CLIP_WORDS[:4]]
    templated = json.dumps([{"role": "user", "content": "Caption this photo: a red car on a wet road, a red car on a "
                                                        "wet road, a red car on a wet road."}])
    zero()
    with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0", LUMEN_GRPC_WORKERS=str(n_photos + 16)):
        handle, channel, stub, load_s = boot_server(ocr_yaml(root / "fp16.yaml", root / "cache", tier), device)
    try:
        vlm = handle.services["vlm"].manager
        clip = handle.services["clip"].managers["clip"]
        ocr = handle.services["ocr"].manager
        got_dtypes = {name: str(m.policy.compute_dtype) for name, m in (("vlm", vlm), ("clip", clip), ("ocr", ocr))}
        if set(got_dtypes.values()) != {"torch.float16"}:
            raise AssertionError(f"phase 23 (a): the tier computes in {got_dtypes}, not float16")
        size = clip.cfg.image_size
        pixels = [_spec_clip_resize(p, {"size": size}) for p in photo_batch(seed * 100 + 23, n_photos)]
        ocr_meta = {"det_thresh": 0.3, "box_thresh": 0.3, "rec_thresh": 0.0, "use_angle_cls": "true"}

        def job(i: int) -> dict:
            if i < n_captions:
                return grpc_call(stub, "vlm_generate", photos[i], {"messages": templated, "max_new_tokens": tokens})
            i -= n_captions
            if i < n_streams:
                return grpc_call(stub, "vlm_generate_stream", photos[n_captions + i],
                                 {"messages": templated, "max_new_tokens": tokens})
            i -= n_streams
            if i < n_photos:
                payload, tmeta = tensor_payload(pixels[i])
                return grpc_call(stub, "clip_image_embed", payload, tmeta, mime=TENSOR_MIME)
            i -= n_photos
            if i < len(texts):
                return grpc_call(stub, "clip_text_embed", texts[i].encode(), {}, mime="text/plain")
            i -= len(texts)
            if i < 2:
                return grpc_call(stub, "clip_classify", phase6["photos"][i], {"top_k": 5})
            i -= 2
            return grpc_call(stub, "ocr", pages[i][0], ocr_meta)

        n_jobs = n_captions + n_streams + n_photos + len(texts) + 2 + n_pages
        eng = vlm.engine
        turns0 = eng.spec_turns
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            res = list(pool.map(job, range(n_jobs)))
        wall = time.perf_counter() - t0
        sampled = grpc_call(stub, "vlm_generate", photos[-1], {"messages": templated, "max_new_tokens": 8,
                                                               "temperature": 0.8, "do_sample": "true"})
        a_launches = dtype_launches(kernels)
        peak_a = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        bad = [(i, r["code"]) for i, r in enumerate(res + [sampled]) if r["code"]]
        if bad:
            raise AssertionError(f"phase 23 (a): requests failed (index, code): {bad}")
        turns = eng.spec_turns - turns0
        if not turns:
            raise AssertionError(f"phase 23 (a): speculation (K = {eng.spec_k}) never verified a window in float16 "
                                 f"({eng.spec_proposed} proposals, {eng.blocks_run} blocks)")
        caps, streams = res[:n_captions], res[n_captions:n_captions + n_streams]
        embeds = res[n_captions + n_streams:n_captions + n_streams + n_photos]
        pages_out = res[-n_pages:]
        # captions: each equal to the manager's rerun alone; streams' deltas join to their final
        from lumen_tpu_torch.models.vlm import ChatMessage

        msgs = [ChatMessage("user", json.loads(templated)[0]["content"])]
        n_tokens = 0
        for i, r in enumerate(caps):
            alone = vlm._generate_uncached(msgs, None, tokens, 0.0, 1.0, False, 1.0, None, True, photos[i])
            if (alone.text, len(alone.tokens)) != (r["body"]["text"], r["body"]["generated_tokens"]):
                raise AssertionError(f"phase 23 (a): caption {i} differs from its rerun alone")
            n_tokens += r["body"]["generated_tokens"]
        for i, r in enumerate(streams):
            if b"".join(r["deltas"]).decode() != r["body"]["text"] or not 1 <= r["body"]["generated_tokens"] <= tokens:
                raise AssertionError(f"phase 23 (a): stream {i}: deltas do not join to its final text")
            n_tokens += r["body"]["generated_tokens"]
        vlm_cos, vlm_nonfinite = forward_check(vlm.model, vlm_cfg, vlm_modeling, seed + 231, device, f16,
                                               "phase 23 (a) VLM float16")
        # CLIP: the served float16 embeddings against the manager's towers on the plain attention
        vecs = np.stack([np.asarray(r["body"]["vector"], np.float64) for r in embeds])
        with plain_attention(clip_modeling):
            ref = clip._encode_images(clip.model, torch.from_numpy(np.stack(pixels)).to(device)).float().cpu().numpy()
        norms = np.linalg.norm(vecs, axis=-1)
        cos_clip = cosines(vecs, ref)
        if not np.isfinite(vecs).all() or np.abs(norms - 1).max() > 1e-3 or cos_clip.min() < CLIP_COSINE:
            raise AssertionError(f"phase 23 (a): float16 CLIP embeddings: norms {norms.min():.5f}-{norms.max():.5f}, "
                                 f"cosine to the plain attention min {cos_clip.min():.6f}")
        # OCR: boxes equal to the plain path's on the same pages, texts counted
        reset_result_cache()
        with plain_attention(ocr_modeling):
            plain_ocr = [ocr.predict(jpeg, det_threshold=0.3, box_threshold=0.3, rec_threshold=0.0, use_angle_cls=True)
                         for jpeg, _ in pages]
        n_items = n_same = 0
        for r, want in zip(pages_out, plain_ocr):
            items = r["body"]["items"]
            if len(items) != len(want) or any(ref_quad_iou(it["box"], w.box) < OCR_IOU for it, w in zip(items, want)):
                raise AssertionError("phase 23 (a): the float16 OCR boxes differ from the plain path's")
            n_items += len(items)
            n_same += sum(it["text"] == w.text for it, w in zip(items, want))
        if not n_items:
            raise AssertionError("phase 23 (a): the float16 OCR read no item on any page")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    reset_result_cache()
    add_launches(out["launches"], a_launches)
    log(f"phase 23 (a) [{card}]: float16 tier (vlm + clip + ocr) up in {load_s:.2f} s; {n_captions} captions and "
        f"{n_streams} streams ({n_tokens} tokens, {turns} verify turns), {n_photos} CLIP pixels, {len(texts)} texts, 2 "
        f"labels, {n_pages} OCR pages, all at once in {wall:.3f} s, and a sampled caption; captions equal to their "
        f"reruns alone; VLM cacheless forward cosine {vlm_cos:.6f} to the plain attention ({vlm_nonfinite} logits not "
        f"finite on both); CLIP cosine min {cos_clip.min():.6f}; OCR {n_items} items, boxes equal to the plain path's, "
        f"texts equal in {n_same}; peak {peak_a:.3f} GiB; float16 launches {json.dumps(a_launches)}")
    out.update(a_load_s=load_s, a_tokens=n_tokens, a_turns=turns, a_clip_cos=float(cos_clip.min()), a_vlm_cos=vlm_cos,
               a_vlm_nonfinite=vlm_nonfinite, a_ocr_items=n_items, a_ocr_same=n_same, a_peak_gib=peak_a)

    # -- (b) the Qwen2-MoE decoder, 2 layers at full width, float16 then float32
    cfg = moe_cfg or qwen15_moe_a27b(layers=2)
    dec = cfg.decoder
    out["moe"] = {}
    for name in ("float16", "float32"):
        dt = getattr(torch, name)
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state = seeded_state(cfg, seed + 232, device, dt)
        seed_s = time.perf_counter() - t0
        zero()
        gate = ("flash_attention_cache", "paged_attention_varq" if name == "float16" else "paged_attention")
        drive = drive_serving(seed, card, cfg=cfg, device=device, state=state, dtype=name,
                              spec_k=4 if name == "float16" else 0, sampled=1 if name == "float16" else 0,
                              kernels=gate if on_card else (), label=f"phase 23 (b) MoE {name}")
        model = VLMManager._build_model(cfg, state).eval()
        del state
        cos, nonfinite = forward_check(model, cfg, vlm_modeling, seed + 233, device, dt, f"phase 23 (b) MoE {name}")
        del model
        b_launches = dtype_launches(kernels)
        add_launches(out["launches"], b_launches)
        grouped = b_launches["grouped_mm"].get(name, {}).get(None, 0)
        if on_card and not grouped:
            raise AssertionError(f"phase 23 (b): the MoE decoder in {name} never launched the grouped product")
        out["moe"][name] = dict(tok_s=drive["tok_s"], tokens=drive["tokens"], peak_gib=drive["peak_gib"],
                                forward_cos=cos, nonfinite=nonfinite, grouped_launches=grouped, seed_s=seed_s)
        log(f"phase 23 (b) [{card}]: MoE decoder ({dec.layers} layers, full width) in {name}: {drive['tokens']} "
            f"tokens, {drive['tok_s']:.1f} tok/s, peak {drive['peak_gib']:.3f} GiB; cacheless forward cosine {cos:.6f} "
            f"to the plain attention ({nonfinite} logits not finite on both); grouped product launches {grouped}; "
            f"launches {json.dumps(b_launches)}")

    # one MoEFFN layer at full width, 8 tokens: syncs a call in each type
    syncs, errs = {}, {}
    for name in ("bfloat16", "float16", "float32"):
        dt = getattr(torch, name)
        with torch.device("meta"):
            layer = vlm_modeling.MoEFFN(dec)
        layer = vlm_modeling.init_random_(layer.to(dt).to_empty(device=device), seed + 234)
        x = torch.randn((1, 8, dec.hidden_size), generator=torch.Generator(device=device).manual_seed(seed + 235),
                        device=device).to(dt)
        params = M.MoEParams(layer.router, layer.w_gate, layer.w_up, layer.w_down)
        with torch.no_grad():
            routed = M._moe_exact_local(params, x.reshape(-1, dec.hidden_size), n_experts=dec.moe_experts,
                                        k=dec.moe_top_k, norm_topk=dec.moe_norm_topk, mm=M.grouped_mm_reference)
            plain = routed.reshape(x.shape) + torch.sigmoid(layer.shared_gate(x)) * layer.shared(x)
            errs[name] = max_err(layer(x), plain)
            if on_card:
                syncs[name] = count_syncs(lambda: layer(x))
        del layer
    if on_card and len(set(syncs.values())) != 1:
        raise AssertionError(f"phase 23 (b): MoEFFN device-to-host syncs a call differ by dtype: {syncs}")
    out.update(moe_syncs=syncs, moe_layer_err=errs)
    log(f"phase 23 (b) [{card}]: one MoEFFN layer (8 tokens, full width) within tolerance of its plain per-expert loop "
        f"({json.dumps({k: f'{v:.3e}' for k, v in errs.items()})}); device-to-host syncs a call {json.dumps(syncs)}")

    if on_card:
        missing = [k for k in PHASE23_FP16_KERNELS if not sum(out["launches"].get(k, {}).get("float16", {}).values())]
        missing += [f"grouped_mm {dt}" for dt in PHASE23_GROUPED_DTYPES
                    if not sum(out["launches"].get("grouped_mm", {}).get(dt, {}).values())]
        if missing:
            raise AssertionError(f"phase 23: never launched {missing} ({json.dumps(out['launches'])})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def vlm_config_of(model_dir):
    """The ``VLMConfig`` a model directory's ``config.json`` describes."""
    from lumen_tpu_torch.models.vlm import VLMConfig

    return VLMConfig.from_hf(json.loads((Path(model_dir) / "config.json").read_text()))


def count_syncs(fn) -> int:
    """Device-to-host synchronizations one call of ``fn`` makes (warm), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # (set_sync_debug_mode's own "prototype feature" notice is no sync)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


#: the phases whose results each phase reads (``--phases`` runs them too)
PHASE_NEEDS = {7: (6,), 8: (6,), 9: (8,), 10: (6, 8, 9), 11: (8, 9, 10), 12: (6, 8), 13: (6,), 14: (6, 9, 10, 12),
               17: (6, 8), 19: (2, 8, 9), 20: (6, 8, 9), 21: (6, 8, 9, 12), 22: (6, 8), 23: (6, 8, 10)}
ALL_PHASES = frozenset(range(1, 24))


def phase_set(spec: "str | None") -> frozenset:
    """The phases a run drives: all, or those ``spec`` lists (``6,13``)
    with the phases they read, and phase 1 (the build) always."""
    want = set(ALL_PHASES) if spec is None else {int(p) for p in spec.split(",")}
    if not want <= ALL_PHASES:
        raise SystemExit(f"--phases: no phase {sorted(want - ALL_PHASES)}")
    todo = list(want)
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in want:
                want.add(need)
                todo.append(need)
    return frozenset(want | {1})


#: the lanes beside the main one: the main-lane phase after which each
#: starts, and its phases in order (see the module's docstring)
BESIDE_LANES = ((8, (12, 14, 21, 23)), (15, (16, 22)))
BESIDE_PHASES = frozenset(p for _, phases in BESIDE_LANES for p in phases)


def beside_plan(run: frozenset) -> list[tuple[int, tuple, dict]]:
    """The lanes a run of ``run`` starts: (the main-lane phase after which
    it starts, its phases, the main-lane phases each must wait for)."""
    plan = []
    for after, phases in BESIDE_LANES:
        mine = tuple(p for p in phases if p in run)
        if mine:
            waits = {p: sorted(n for n in PHASE_NEEDS.get(p, ()) if n in run and n not in phases) for p in mine}
            plan.append((after, mine, waits))
    return plan


class Beside:
    """A lane of phases in a process of its own (``chip_smoke.py --beside
    <spec>``), started at construction: its lines are echoed as they come,
    but for the last, what each phase returned. :meth:`result` waits for
    it and raises unless it exited 0 with that line; :meth:`stop` ends it
    (SIGTERM: its ``finally`` blocks stop what it started)."""

    MARK = "beside-result "

    def __init__(self, phases: tuple, spec: dict):
        self.phases = phases
        spec = {**spec, "phases": list(phases), "parent": os.getpid()}
        self.proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--beside", json.dumps(spec)],
                                     cwd=ROOT, stdout=subprocess.PIPE, text=True,
                                     env={**os.environ, "PYTHONPATH": str(ROOT)})
        self.results = None
        self.reader = threading.Thread(target=self._echo, daemon=True)
        self.reader.start()

    def _echo(self) -> None:
        for line in self.proc.stdout:
            if line.startswith(self.MARK):
                self.results = {int(p): r for p, r in json.loads(line[len(self.MARK):]).items()}
            else:
                sys.stdout.write(line)
                sys.stdout.flush()

    def result(self) -> dict:
        rc = self.proc.wait()
        self.reader.join(timeout=60)
        if rc or self.results is None:
            raise AssertionError(f"phases {list(self.phases)}, run beside the main lane, failed: exit code {rc}")
        return self.results

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def ended_path(root: Path, phase: int) -> Path:
    """The file the main lane writes once ``phase`` has ended."""
    return root / "ended" / str(phase)


def run_phase12(seed: int, card: str, root: Path, given: dict) -> dict:
    # depth cut: 2 captions beside 1 stream of 12 tokens, one A/B boot (were 8, 2 of 24 tokens, 2)
    options = drive_vlm_options(seed, card, root, given[6], given[8], n_captions=2, n_streams=1, tokens=12,
                                ab_boots=1)
    co_bf16, co_int8 = options["coalesce_bf16"], options["coalesce_int8"]
    log(f"phase 12 [{card}]: {options['phase_s']:.1f} s in all; (a) graph tower exported in {options['export_s']:.1f} s, "
        f"served in {options['fast_load_s']:.2f} s, {options['tower_ms']:.2f} ms a forward ({options['tower_nodes']} "
        f"nodes), stream ttft p50 {options['ttft_p50_ms']:.1f} ms, _prepare syncs {options['prepare_syncs']}; (b) A/Bs "
        f"{' and '.join(f'{b:.1f} vs {q:.1f}' for b, q in zip(options['ab_bf16_tps'], options['ab_q8_tps']))} tok/s "
        f"(ratios {', '.join(f'{r:.3f}' for r in options['ab_ratios'])}) -> {options['ab_route']}, peak above the "
        f"start {', '.join(f'{m:.1f}' for m in options['ab_peak_mib'])} MiB, boots "
        f"{', '.join(f'{t:.2f}' for t in options['boot_ab_s'])} / {options['boot_verdict_s']:.2f} s; (c) "
        f"coalesce {co_bf16['tok_s']:.1f} (bf16) / {co_int8['tok_s']:.1f} (int8) tok/s, syncs a decode step "
        f"{co_bf16['syncs']:.2f} / {co_int8['syncs']:.2f} (before the repair {co_bf16['syncs_old']:.2f} / "
        f"{co_int8['syncs_old']:.2f}); (d) CLIP batch of 64 {options['clip_bf16_ms']:.3f} ms bf16 vs "
        f"{options['clip_q8_ms']:.3f} ms W8A8 -> {options['clip_route']}, cosine {options['clip_cos']:.6f}")
    return options


def run_phase14(seed: int, card: str, root: Path, given: dict) -> dict:
    models = root / "cache" / "models"
    # depth cut: captions of 16 new tokens (were 64)
    control = drive_control_plane(card, root, given[6]["photos"],
                                  {name: models / src for name, src in CATALOG_SOURCES.items()}, caption_tokens=16)
    log(f"phase 14 [{card}]: {control['phase_s']:.1f} s in all; the full tier under the app's ServerManager "
        f"ready in {control['cold_s']:.2f} s cold and {control['warm_s']:.2f} s warm; the first caption "
        f"{control['cold_first_s']:.2f} s cold ({control['cold_builds']} kernel builds) and "
        f"{control['warm_first_s']:.2f} s warm (0 builds); launches {json.dumps(control['launches'])}, child "
        f"peak {control['peak_gib']:.3f} GiB")
    return control


def run_phase16(seed: int, card: str, root: Path, given: dict) -> dict:
    # depth cut: 20 steps (was 30; the rate over steps 16-20)
    train = drive_train(seed, card, root, steps=20)
    log(f"phase 16 [{card}]: {train['phase_s']:.1f} s in all; {train['pairs_s']:.1f} image-text pairs/s "
        f"({train['steps_s']:.3f} steps/s at batch 256, fp32), peak {train['peak_gib']:.3f} GiB "
        f"(remat {train['peak_remat_gib']:.3f}), 0 flash launches in training, card vs CPU loss within "
        f"{train['parity_loss_err']:.2e}, resume within {train['resume_err']:.2e}")
    return train


def run_phase21(seed: int, card: str, root: Path, given: dict) -> dict:
    models = root / "cache" / "models"
    graph = drive_graph_group(seed, card, root, models / "SmokeFastVLM", models / "SmokeMobileCLIP", given[6]["photos"])
    a = graph["a_readouts"]
    log(f"phase 21 [{card}]: {graph['phase_s']:.1f} s in all, parts {json.dumps(graph['parts_s'])}; "
        f"{json.dumps(GRAPH_GROUP_AXES)} as 2 gloo ranks on the card named twice, the dp_tp preset's clip and vlm "
        f"blocks served up in {graph['load_s']:.2f} s: (a) VLM 2 replicas of {{model: 2}} with the FastViTHD graph "
        f"tower on rank 0 ({graph['tower_gib']:.3f} GiB; graph CLIP {graph['clip_gib']:.3f} GiB there too), held GiB a "
        f"rank {[round(g, 3) for g in graph['held_gib']]}, peak GiB a rank {[round(g, 3) for g in graph['a_peak_gib']]}; "
        f"first-step logits {json.dumps(graph['a_first'])}, equal prefixes {graph['a_prefix']} of "
        f"{graph['a_lengths']} (partings {json.dumps(graph['a_parted'])}), launches a rank (rows) and place (columns) "
        f"{json.dumps({k: a[k]['launches'] for k in a})}, device-to-host syncs of one prepare step on rank 0 "
        f"{graph['a_prepare_syncs']}; (b) graph CLIP cosine min {graph['b_cos']:.6f} over {graph['b_batches']} "
        f"batches, {graph['b_fetches_per_batch']:.2f} device-to-host copies a batch, group programs "
        f"{graph['b_programs']}, rank 1's programs a place {graph['b_rank1_programs']} (the readout's own)")
    return graph


def run_phase22(seed: int, card: str, root: Path, given: dict) -> dict:
    seq = drive_seq(seed, card, root, given[6]["model_dir"], given[6]["photos"])
    b = seq["b_readouts"]
    log(f"phase 22 [{card}]: {seq['phase_s']:.1f} s in all, parts {json.dumps(seq['parts_s'])}; (a) CLIP on "
        f"{json.dumps(SEQ_CLIP_AXES)} with the card named four times (idle positions {seq['a_idle']}): cosine min "
        f"{seq['a_cos']:.6f}, flash_attention launches a place {seq['a_per_place']} over {seq['a_batches']} batches, "
        f"weights {seq['a_held_gib']:.3f} GiB vs {seq['a_held_gib_plain']:.3f} for one copy, {seq['a_images_s']:.1f} vs "
        f"{seq['a_images_s_plain']:.1f} images/s mesh-less; (b) the VLM on {json.dumps(SEQ_VLM_AXES)} as 2 gloo ranks "
        f"on the card, served up in {seq['load_s']:.2f} s ({json.dumps(seq['b_layout'])}): first-step logits "
        f"{json.dumps(seq['b_first'])}, equal prefixes {seq['b_prefix']} of {seq['b_lengths']} (partings "
        f"{json.dumps(seq['b_parted'])}), {seq['b_tok_s']:.1f} tok/s, launches a rank "
        f"{json.dumps({k: b[k]['launches'] for k in b})}, peak GiB a rank {[round(g, 3) for g in seq['b_peak_gib']]}")
    return seq


def run_phase23(seed: int, card: str, root: Path, given: dict) -> dict:
    fp16 = drive_fp16(seed, card, root, given[6])
    moe = fp16["moe"]
    log(f"phase 23 [{card}]: {fp16['phase_s']:.1f} s in all; (a) the float16 tier up in {fp16['a_load_s']:.2f} s, "
        f"{fp16['a_tokens']} caption tokens ({fp16['a_turns']} verify turns), CLIP cosine min {fp16['a_clip_cos']:.6f}, "
        f"VLM forward cosine {fp16['a_vlm_cos']:.6f}, OCR {fp16['a_ocr_items']} items, peak {fp16['a_peak_gib']:.3f} GiB; "
        f"(b) the 2-layer MoE decoder: float16 {moe['float16']['tok_s']:.1f} tok/s (peak {moe['float16']['peak_gib']:.3f} "
        f"GiB), float32 {moe['float32']['tok_s']:.1f} tok/s (peak {moe['float32']['peak_gib']:.3f} GiB), syncs a MoE "
        f"layer call {json.dumps(fp16['moe_syncs'])}; launches by type and head_dim {json.dumps(fp16['launches'])}")
    return fp16


BESIDE_RUNNERS = {12: run_phase12, 14: run_phase14, 16: run_phase16, 21: run_phase21, 22: run_phase22,
                  23: run_phase23}


def die_with_parent(parent: int) -> None:
    """In a lane's process: SIGTERM becomes ``SystemExit`` (every
    ``finally`` then stops what it started), and the process takes SIGTERM
    when the one that started it ends."""
    import ctypes
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with contextlib.suppress(Exception):  # prctl(PR_SET_PDEATHSIG, SIGTERM): Linux
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)
    if os.getppid() != parent:
        sys.exit(143)


def beside_main(spec: dict) -> int:
    """A lane's process: its phases in order, each once the main-lane
    phases it waits for have ended; the last line is what each returned."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    die_with_parent(spec["parent"])
    from lumen_tpu_torch.runtime.decode_pool import shutdown_decode_pool

    card = card_line()
    root = Path(spec["root"])
    given = pickle.loads(Path(spec["inputs"]).read_bytes())
    out = {}
    try:
        for phase in spec["phases"]:
            for need in spec["waits"][str(phase)]:
                deadline = time.monotonic() + 1200
                while not ended_path(root, need).exists():
                    if time.monotonic() > deadline:
                        raise AssertionError(f"phase {phase}: phase {need} of the main lane never ended")
                    time.sleep(0.5)
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
            out[phase] = BESIDE_RUNNERS[phase](spec["seed"], card, root, given)
    finally:
        shutdown_decode_pool()
    print(Beside.MARK + json.dumps(out, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)), flush=True)
    return 0


def main() -> int:
    if not (ROOT / "lumen_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serve-host"]:  # phase 13's hosts: the server CLI's own arguments follow
        sys.path.insert(0, str(ROOT))
        return serve_host(sys.argv[2:])
    if sys.argv[1:2] == ["--beside"]:  # a lane beside the main one: its spec follows
        return beside_main(json.loads(sys.argv[2]))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # a developer's shortcut, e.g. ``--phases 13``: those phases and what they
    # read, without the kernel table and the device line
    parser.add_argument("--phases", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    run = phase_set(args.phases)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lumen_tpu_torch.ops.cuda_build import build_all

    kernels = all_kernels()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    laps, mark = {}, [time.perf_counter()]
    t_run = mark[0]
    # the lanes beside the main one, and what their phases read of the
    # main lane's (pickled for each lane when it starts)
    lanes = [dict(after=after, phases=phases, waits=waits, proc=None) for after, phases, waits in beside_plan(run)]
    here: dict = {}
    given: dict = {}

    def start_lanes(ended: int) -> None:
        for i, lane in enumerate(lanes):
            if lane["proc"] is None and lane["after"] <= ended:
                inputs = here["tmp"] / f"lane-{i}-inputs.pkl"
                inputs.write_bytes(pickle.dumps(given))
                torch.cuda.empty_cache()  # what this process holds and no longer uses goes back to the card
                lane["proc"] = Beside(lane["phases"], dict(seed=args.seed, root=str(here["tmp"]), inputs=str(inputs),
                                                          waits=lane["waits"]))
                log(f"phase{'s' * (len(lane['phases']) > 1)} {', '.join(map(str, lane['phases']))} started beside "
                    f"the main lane after phase {ended}")

    def lap(phase: int) -> None:  # each phase's seconds, printed at the end
        now = time.perf_counter()
        laps[phase], mark[0] = round(now - mark[0], 1), now
        if "tmp" in here:
            failed = [lane["phases"] for lane in lanes if lane["proc"] is not None and lane["proc"].proc.poll()]
            if failed:
                raise AssertionError(f"phases {failed}, run beside the main lane, failed")
            ended_path(here["tmp"], phase).touch()
            start_lanes(phase)

    def join_lanes() -> dict:
        if not lanes:
            return {}
        start_lanes(max(ALL_PHASES))
        t0 = time.perf_counter()
        results = {}
        for lane in lanes:
            results.update(lane["proc"].result())
        for phase, res in results.items():
            laps[phase] = round(res["phase_s"], 1)
        mark[0] = time.perf_counter()
        log(f"lanes joined: phases {', '.join(map(str, sorted(results)))}, the main lane waited "
            f"{mark[0] - t0:.1f} s for them [{card}]")
        return results

    def stop_lanes() -> None:
        for lane in lanes:
            if lane["proc"] is not None:
                lane["proc"].stop()

    t0 = time.perf_counter()
    logs = build_all(kernels + moe_kernels())
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s ({len(logs)} libraries, one nvcc a source, all started together)")
    for r in ptxas_report(logs):
        log(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
            f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads")
        if ("_mma_kernel" in r["func"] or r["func"].startswith("paged_walk")) and r["spill_stores"] + r["spill_loads"]:
            raise AssertionError(f"{r['func']} spills: the 2-byte flash kernels and the paged walk must stay in "
                                 "registers")
    hmma = hmma_counts([k for k in kernels if k.name != "w8a16_matmul"])
    log("sass (cuobjdump -sass), HMMA instructions: "
        + ", ".join(f"{func} {n}" for func, n in sorted(hmma.items())))
    # flash's short and long paths at head_dim 64, 16 and 128, the cache
    # kernel at 64 and 128, each in bf16 and fp16
    types = ("__nv_bfloat16", "__half")
    mma_funcs = {f for f in hmma if f.startswith("flash_") and "_mma_kernel" in f}
    want = {f"flash_{path}_mma_kernel<{t}, {d}>" for path in ("short", "long") for t in types for d in (16, 64, 128)}
    want |= {f"flash_attention_cache_mma_kernel<{t}, {d}>" for t in types for d in (64, 128)}
    if mma_funcs != want or any(hmma[f] == 0 for f in mma_funcs):
        raise AssertionError(f"the bf16 and fp16 flash kernels must run on the tensor cores: HMMA {hmma}")
    paged_mma = {f for f in hmma if f.startswith("paged_walk_mma_kernel")}
    if paged_mma != {f"paged_walk_mma_kernel<{t}, {d}>" for t in types for d in (64, 128)} or any(
            hmma[f] == 0 for f in paged_mma):
        raise AssertionError(f"the paged walk's bf16 and fp16 GQA path must run on the tensor cores: HMMA {hmma}")
    lap(1)

    if 2 in run:
        rows = check_kernels(args.seed)
        rows["paged_attention_varq"] = check_varq(args.seed)
        rows["w8a16_matmul"] = check_w8a16(args.seed)
        rows.update(check_hd128(args.seed))
        rows["w8a16_matmul [Qwen1.5-MoE]"] = check_w8a16(args.seed + 15, MOE_Q8_SHAPES, "shared gate/up_proj")
        rows.update(check_fp16(args.seed))
        rows.update(check_grouped_mm(args.seed))
        lap(2)
    if 3 in run:
        check_reference(args.seed)
        lap(3)
    drives = {}
    if 4 in run:
        drives[4] = drive_serving(args.seed, card)
        lap(4)
    if 5 in run:
        drives[5] = drive_serving(args.seed, card, quantize="int8", spec_k=4, kernels=PHASE5_KERNELS)
        lap(5)
    if {4, 5} <= run:
        a, b = drives[4], drives[5]
        log(f"phase 4 vs 5 [{card}]: tok/s {a['tok_s']:.1f} (bf16) vs {b['tok_s']:.1f} (int8 + spec K=4); "
            f"peak GiB {a['peak_gib']:.3f} vs {b['peak_gib']:.3f}; stream ttft_ms {a['ttft_ms']} vs "
            f"{b['ttft_ms']}; accept rate {b['spec_accepted'] / max(b['spec_proposed'], 1):.3f}")
    import pickle
    import tempfile

    from lumen_tpu_torch.runtime.decode_pool import shutdown_decode_pool

    # a phase that fails leaves no decode worker process behind
    with contextlib.ExitStack() as stack:
        stack.callback(shutdown_decode_pool)
        tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="lumen-chip-smoke-"))
        here["tmp"] = Path(tmp)
        (Path(tmp) / "ended").mkdir()
        stack.callback(stop_lanes)  # (before the directory goes)
        if 6 in run:
            grpc_drive = drive_grpc(args.seed, card, root=Path(tmp))
            log(f"phase 6 [{card}]: load {grpc_drive['load_s']:.2f} s (bf16), {grpc_drive['load8_s']:.2f} s (int8); "
                f"{grpc_drive['tok_s']:.1f} tok/s aggregate over gRPC; client ttft_ms {grpc_drive['ttft_ms']}; "
                f"peak GiB {grpc_drive['peak_gib']:.3f}")
            given[6] = {k: grpc_drive[k] for k in ("model_dir", "photos", "prompt")}
            lap(6)
        if 7 in run:
            # depth cut for phases 17-18's room: 1 of the 6 greedy streams rerun alone (every one still
            # equals phase 6's unpressured answer)
            defaults = drive_defaults(args.seed, card, Path(tmp), grpc_drive, alone_reruns=1)
            log(f"phase 7 [{card}]: {defaults['phase_s']:.1f} s in all; load {defaults['load_s']:.2f} s; "
                f"{defaults['preempted']} preemptions, "
                f"{defaults['resumed']} spill resumes, {defaults['prefix_hits']} prefix hits, a result-cache answer in "
                f"{defaults['cached_ms']:.2f} ms; launches {json.dumps(defaults['launches'])}")
            lap(7)
        if 8 in run:
            clip = drive_clip(args.seed, card, Path(tmp), grpc_drive)
            log(f"phase 8 [{card}]: {clip['phase_s']:.1f} s in all; load {clip['load_s']:.2f} s (labels "
                f"{clip['label_s']:.3f} s of it), hub {clip['hub_s']:.2f} s; cold round {clip['cold_s']:.2f} s; "
                f"{clip['images_s']:.1f} images/s over gRPC (one batch of 64 {clip['batch_ms']:.3f} ms on the device), "
                f"client p50 {clip['p50_ms']:.1f} ms p95 {clip['p95_ms']:.1f} ms, mean batch fill {100 * clip['fill']:.1f}%, "
                f"decode {clip['decode_ms']:.2f} ms a photo, peak GiB {clip['peak_gib']:.3f}; cosine to the plain path min "
                f"{clip['cos_min']:.6f}")
            given[8] = {k: clip[k] for k in ("photos", "vecs")}
            lap(8)
        if 9 in run:
            # depth cut for phase 17's room: 16 photos a pass (was 128)
            face = drive_face(args.seed, card, Path(tmp), clip, n_photos=16)
            log(f"phase 9 [{card}]: {face['phase_s']:.1f} s in all; stand-in pack exported in {face['export_s']:.1f} s, "
                f"face server up in {face['load_s']:.2f} s; {face['photos_s']:.1f} photos/s face_detect over gRPC with TF32 "
                f"convolutions ({face['photos_s_ieee']:.1f} in IEEE float32), client p50 {face['p50_ms']:.1f} ms p95 "
                f"{face['p95_ms']:.1f} ms, mean batch fill {100 * face['fill']:.1f}%; one detector batch of 16 "
                f"{face['det_ms']:.3f} ms (TF32 {face['det_tf32_ms']:.3f} ms), one embedder batch of 16 {face['rec_ms']:.3f} "
                f"ms (TF32 {face['rec_tf32_ms']:.3f} ms); NMS {face['nms_launches']} launches, {face['nms_host_ms']:.2f} host "
                f"ms a batch; syncs per forward {json.dumps(face['syncs'])}; peak GiB {face['peak_gib']:.3f}; IEEE: "
                f"{face['faces']} faces matched at IoU >= {face['iou_min']:.5f}, embeddings cosine >= {face['cos_min']:.6f}; "
                f"TF32: matched at IoU >= {face['tf32']['iou_min']:.5f}, {json.dumps(face['tf32'])}; graph CLIP exported in "
                f"{face['clip_export_s']:.1f} s, served in {face['clip_load_s']:.2f} s, cosine to phase 8 >= "
                f"{face['clip_cos']:.6f}; hub flash_attention launches {face['hub_launches']}")
            lap(9)
        if 10 in run:
            # depth cut for phases 17-18's room: 4 pages (was 32, then 8)
            ocr = drive_ocr(args.seed, card, Path(tmp), grpc_drive, clip, face, n_pages=4)
            log(f"phase 10 [{card}]: {ocr['phase_s']:.1f} s in all ((a) {ocr['a_s']:.1f} s, (b) {ocr['b_s']:.1f} s); stand-in pack exported in {ocr['export_s']:.1f} s, OCR "
                f"server up in {ocr['load_s']:.2f} s; {ocr['pages_s']:.2f} pages/s over gRPC with TF32 convolutions "
                f"({ocr['pages_s_ieee']:.2f} in IEEE float32), client p50 {ocr['p50_ms']:.1f} ms p95 {ocr['p95_ms']:.1f} ms; one "
                f"detector call {ocr['det_ms']:.3f} ms (IEEE {ocr['det_ieee_ms']:.3f}), one recognizer chunk of 16 "
                f"{ocr['rec_ms']:.3f} ms (IEEE {ocr['rec_ieee_ms']:.3f}); host postprocess {ocr['post_ms']:.2f} ms a page; "
                f"syncs per forward {json.dumps(ocr['syncs'])}; peak GiB {ocr['peak_gib']:.3f}; IEEE: {ocr['items']} items "
                f"matched at IoU >= {ocr['iou_min']:.5f}; TF32: {json.dumps(ocr['tf32'])}; native bf16: flash_attention "
                f"(head_dim 16) {ocr['native_launches']} launches over {ocr['native_chunks']} recognizer chunks, logits within "
                f"{ocr['bf16_logit_share']:.2e} of the plain path's scale; full tier up in {ocr['hub_s']:.2f} s, launches "
                f"{json.dumps(ocr['hub_launches'])}")
            lap(10)
        if 11 in run:
            # depth cut for phases 17-18's room: 16 photos through the CLI, 4 with captions of 16 tokens,
            # 50,000 vectors and 128 queries (were 128, 16 of 32, 200,000, 512, then 32, 8, 100,000, 256)
            ingest = drive_ingest(args.seed, card, Path(tmp), clip, face, ocr, n_photos=16, n_captions=4,
                                  caption_tokens=16, n_vectors=50_000, n_queries=128)
            log(f"phase 11 [{card}]: {ingest['phase_s']:.1f} s in all; tier + search up in {ingest['boot_s']:.2f} s; ingest "
                f"{ingest['images_s']:.2f} images/s (CLI, clip + face + ocr, batch 64), stage device ms a batch "
                f"{json.dumps({k: round(v, 3) for k, v in ingest['stage_ms'].items()})}, syncs flagged "
                f"{ingest['syncs_flagged']} in the sweep; launches {json.dumps(ingest['launches'])}, warm re-run none; "
                f"search: {ingest['upsert_rows_s']:,.0f} rows/s upserted, query p50 {ingest['p50_ms']:.2f} ms p95 "
                f"{ingest['p95_ms']:.2f} ms at 16 in flight ({ingest['mean_pass']:.1f} queries a shard pass; alone p50 "
                f"{ingest['solo_p50_ms']:.2f} ms), {ingest['near_ties']} near-ties, a full-shard scoring pass "
                f"{ingest['pass_ms']:.4f} ms (bound {ingest['pass_bound_ms']:.4f}); peak GiB {ingest['peak_gib']:.3f}")
            lap(11)
        if 13 in run:
            # depth cut for phases 17-18's room: 2 captions beside the 2 streams of 16 tokens, (b)'s streams
            # of 48, 20,000 vectors and 32 search queries in (d) (were 8, 32 tokens, 96, 50,000, 128, then 2,
            # 32, 96, 50,000, 64)
            fleet = drive_fleet(args.seed, card, Path(tmp), grpc_drive, n_captions=2, max_new=16, fallback_new=48,
                                n_vectors=20_000, n_queries=32)
            log(f"phase 13 [{card}]: {fleet['phase_s']:.1f} s in all; {fleet['requests']} migrated rows equal to the "
                f"colocated control, {fleet['row_bytes'] / 1e6:.3f} MB a row, {fleet['fallbacks']} fallbacks in (b), "
                f"aggregate {fleet['tok_s_migrated']:.1f} tok/s migrated vs {fleet['tok_s_colocated']:.1f} colocated; "
                f"search {fleet['search_near_ties']} near-ties")
            lap(13)
        if 15 in run:
            moe = drive_moe(args.seed, card, Path(tmp))
            log(f"phase 15 [{card}]: {moe['phase_s']:.1f} s in all; (a) {moe['params'] / 1e9:.3f}B parameters, bf16 "
                f"{moe['bf16']['tok_s']:.1f} tok/s (peak {moe['bf16']['peak_gib']:.3f} GiB), int8 + spec "
                f"{moe['int8']['tok_s']:.1f} tok/s (peak {moe['int8']['peak_gib']:.3f} GiB), forward cosine "
                f"{moe['forward_cos']:.6f}; (b) {moe['dir_gib']:.2f} GiB directory served in {moe['grpc_load_s']:.2f} s, "
                f"{moe['grpc_tok_s']:.1f} tok/s over gRPC; (c) MoEFFN {moe['layer']['ms']:.4f} ms (bound "
                f"{moe['layer']['bound_ms']:.5f} ms, {moe['layer']['distinct_experts']} experts), grouped product "
                f"{moe['layer']['grouped_mm_ms']:.4f} ms")
            lap(15)
        if 17 in run:
            torch.cuda.empty_cache()
            # depth cut for phases 18 and 20's room: 2 fp32 text streams in (a), 4 photo requests in (b)
            # (were 8 and 8, then 4 and 8)
            tp = drive_tp(args.seed, card, Path(tmp), grpc_drive["model_dir"], Path(tmp) / "cache" / "models" / "SmokeCLIP",
                          grpc_drive["photos"], n_streams=2, n_photos=4)
            log(f"phase 17 [{card}]: {tp['phase_s']:.1f} s in all, parts {json.dumps(tp['parts_s'])}; TP = 2 as two "
                f"ranks sharing the card over gloo, not NCCL; (a) fp32: {tp['a_streams']} streams' greedy tokens "
                f"({tp['a_tokens']} tokens) equal to TP = 1, served up in {tp['a_load_s']:.2f} s; (e) a spilled TP row "
                f"({tp['spill_row_mb']:.3f} MB) resumed at TP = 1 to the same fp32 tokens; (b) bf16 first-step logits "
                f"cosine {tp['b_cos']:.6f}, max|diff| {tp['b_rel']:.4f} of max|logit|, greedy equal prefixes "
                f"{tp['b_prefix']} of {tp['b_lengths']} tokens (where one parts, the TP = 1 top-2 gap and the TP = 2 "
                f"max|diff| there: {json.dumps(tp['b_parted'])}), {tp['b_tok_s']:.1f} tok/s; (c) int8 + spec K=4 equal "
                f"prefixes {tp['c_prefix']} of {tp['c_lengths']}, accept rate {tp['c_rate']:.3f} at TP = 2 vs "
                f"{tp['c_ref_rate']:.3f} at TP = 1 (w8a16 launches at TP = 1 {tp['c_ref_w8a16']}, at TP = 2 0); (d) CLIP "
                f"cosine to TP = 1 bf16 {tp['d_bf16_cos']}, W8A8 {tp['d_w8a8_cos']}; (f) killed worker: request code "
                f"{tp['f_code']} in {tp['f_fail_s']:.2f} s, Health {tp['f_health']} after {tp['f_health_s']:.2f} s")
            for part in ("a", "b", "c"):
                log(f"phase 17 ({part}) [{card}]: peak GiB a rank {[round(g, 3) for g in tp[f'{part}_peak_gib']]}"
                    + (f"; launches a rank {json.dumps(tp[f'{part}_launches'])}" if part != "a" else ""))
            lap(17)
        if 18 in run:
            torch.cuda.empty_cache()
            # The int8 routing rule's note of a model axis is process-wide and sticky (as in JAX): phase 17
            # closed every manager and stopped its group, so no model axis serves any more; phase 18's
            # mesh-less and expert-axis int8 runs start from none, as a fresh server process would.
            from lumen_tpu_torch.ops import quant_matmul

            quant_matmul._MESH_MODEL_AXIS = 1
            ep = drive_ep(args.seed, card, Path(tmp), Path(tmp) / "cache" / "models" / "SmokeMoE")
            a, b, c = ep["a"], ep["b"], ep["c"]
            log(f"phase 18 [{card}]: {ep['phase_s']:.1f} s in all, parts {json.dumps(ep['parts_s'])}; the ranks share the "
                f"card over gloo, not NCCL; (a) expert 2 ({a['experts_a_rank']} experts a rank), bf16: served up in "
                f"{a['load_s']:.2f} s, first-step logits cosine {a['cos']:.6f}, max|diff| {a['diff']:.4f} ({a['rel']:.4f} of "
                f"max|logit|), greedy equal prefixes {a['prefix']} of {a['lengths']} tokens (where one parts, the mesh-less "
                f"top-2 gap and the max|diff| there: {json.dumps(a['parted'])}), {a['tok_s']:.1f} tok/s; (b) expert 2, int8 "
                f"+ spec K=4: equal prefixes {b['prefix']} of {b['lengths']}, accept rate {b['rate']:.3f} vs {b['ref_rate']:.3f} "
                f"mesh-less; (c) expert 2 x model 2, bf16: served up in {c['load_s']:.2f} s, cosine {c['cos']:.6f}, max|diff| "
                f"{c['diff']:.4f}, equal prefixes {c['prefix']} of {c['lengths']} (partings {json.dumps(c['parted'])})")
            for part in ("a", "b", "c"):
                log(f"phase 18 ({part}) [{card}]: peak GiB a rank {[round(g, 3) for g in ep[part]['peak_gib']]}; launches "
                    f"a rank {json.dumps(ep[part]['launches'])}, by head_dim {json.dumps(ep[part]['instances'])}")
            lap(18)
        beside = join_lanes()
        options, control, graph, seq, fp16 = (beside.get(12), beside.get(14), beside.get(21), beside.get(22),
                                              beside.get(23))
        if 19 in run:
            torch.cuda.empty_cache()
            data = drive_data(args.seed, card, Path(tmp))
            log(f"phase 19 [{card}]: {data['phase_s']:.1f} s in all; one card named twice as {{data: 2}} (no copy between "
                f"cards, one host's cores): (a) CLIP {data['images_s']:.1f} images/s vs {data['images_s_plain']:.1f} "
                f"mesh-less, cosine min {data['cos_min']:.6f}, max|diff| {data['max_diff']:.3e}, flash launches a batch "
                f"{json.dumps(data['per_batch'])}, weights {data['held_gib']:.3f} GiB for two copies vs "
                f"{data['held_gib_plain']:.3f} for one, peak {data['peak_gib']:.3f} vs {data['peak_gib_plain']:.3f} GiB; "
                f"(b) ingest {data['ingest_s']:.1f} vs {data['ingest_s_plain']:.1f} images/s, cosine min "
                f"{data['ingest_cos']:.6f}, syncs a batch {json.dumps(data['syncs'])}"
                + ("; (c), timed in phase 2: " + "; ".join(
                    f"{label} {r['shape']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f}, plain {r['plain_ms']:.4f}, SDPA "
                    f"{r['library_ms']:.4f})" for label, r in ((label, rows[f"flash_attention ({label})"])
                                                              for label in DATA_FLASH_SHAPES)) if 2 in run else ""))
            lap(19)
        if 20 in run:
            torch.cuda.empty_cache()
            # depth cut for the run's room: 32 photos through (b)'s ingest, requests of 8 tokens in (c) (were 64, 12)
            dp = drive_dp_tp(args.seed, card, Path(tmp), grpc_drive["model_dir"], grpc_drive["photos"], n_ingest=32,
                             max_new=8)
            log(f"phase 20 [{card}]: {dp['phase_s']:.1f} s in all, parts {json.dumps(dp['parts_s'])}; {{data: 2, model: "
                f"2}} as 2 gloo ranks on the card named twice, served up in {dp['load_s']:.2f} s: (a) CLIP "
                f"{dp['a_images_s']:.1f} vs {dp['a_images_s_plain']:.1f} images/s mesh-less, cosine min {dp['a_cos']:.6f}, "
                f"top-1 labels equal {dp['a_labels_exact']}, near ties {dp['a_label_ties']}, flash launches a batch a rank "
                f"and place {json.dumps(dp['a_per_batch'])} over {dp['a_batches']} batches, peak GiB a rank and place "
                f"{json.dumps(dp['a_readouts']['peak_gib'])}, synchronize {json.dumps(dp['a_readouts']['sync'])}; (b) "
                f"ingest {dp['b_images_s']:.1f} vs {dp['b_images_s_plain']:.1f} images/s, cosine min {dp['b_cos']:.6f}, "
                f"faces {json.dumps(dp['b_faces'])}, syncs a batch {dp['b_syncs']:.1f}; (c) VLM 2 replicas of {{model: 2}}: "
                f"first-step logits {json.dumps(dp['c_first'])}, equal prefixes {dp['c_prefix']} of {dp['c_lengths']} "
                f"(partings {json.dumps(dp['c_parted'])}), {dp['c_tok_s']:.1f} tok/s, peak GiB a rank "
                f"{[round(g, 3) for g in dp['c_peak_gib']]}; (d) NCCL at world size 1, the place named twice: "
                f"{json.dumps(dp.get('d_probes'))}")
            lap(20)
    beside_note = f" (phases {', '.join(map(str, sorted(BESIDE_PHASES & run)))} beside the main lane)" \
        if BESIDE_PHASES & run else ""
    log(f"seconds a phase: {json.dumps(dict(sorted(laps.items())))}{beside_note}; the run "
        f"{time.perf_counter() - t_run:.1f} s [{card}]")
    if run != ALL_PHASES:
        log(f"phases {', '.join(map(str, sorted(run)))} passed [{card}]")
        return 0
    for label in DATA_FLASH_SHAPES:
        row = rows[f"flash_attention ({label})"]
        used = (f"phase-19 (a) launches {data['launches']} over two places" if label == next(iter(DATA_FLASH_SHAPES))
                else "phase 19 (a) sends no text")
        log(f"kernel row flash_attention {label} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, max|diff| "
            f"{row['max_abs_err']:.3e}, {used} [{card}]")
    for k in kernels:
        counts = ({"(a) a data place": seq["a_per_place"]} if k.name in PHASE22_CLIP_KERNELS else
                  {"(b) a rank": seq["b_readouts"][k.name]["launches"]} if k.name in seq["b_readouts"] else
                  "not on the path")
        log(f"kernel row {k.name}: phase-22 launches {json.dumps(counts)} [{card}]")
    for k in kernels:
        counts = graph["a_readouts"][k.name]["launches"] if k.name in graph["a_readouts"] else "not on the path"
        log(f"kernel row {k.name}: phase-21 (a) launches a rank (rows) and data place (columns) {json.dumps(counts)} "
            f"[{card}]")
    for k in kernels:
        a, b, c = dp["a_readouts"], dp["b_readouts"], dp["c_readouts"]
        counts = ({"(a) CLIP": a["launches"], "(b) ingest": b["launches"]} if k.name == "flash_attention" else
                  {"(c) VLM replicas": c[k.name]["launches"]} if k.name in c else {"(a)-(c)": "not on the path"})
        log(f"kernel row {k.name}: phase-20 launches a rank (rows) and data place (columns) {json.dumps(counts)} "
            f"[{card}]")
    for k in kernels:
        log(f"kernel row {k.name}: phase-18 launches a rank, (a) expert 2 "
            f"{[c[k.name] for c in ep['a']['launches']]}, (b) int8 + spec {[c[k.name] for c in ep['b']['launches']]}, "
            f"(c) expert 2 x model 2 {[c[k.name] for c in ep['c']['launches']]} [{card}]")
    for k in kernels:
        log(f"kernel row {k.name}: phase-17 launches a rank, (b) bf16 {[c[k.name] for c in tp['b_launches']]}, (c) int8 + "
            f"spec {[c[k.name] for c in tp['c_launches']]} [{card}]")
    for k in kernels:
        counts = {part: c[k.name] for part, c in options["launches"].items() if k.name in c}
        log(f"kernel row {k.name}: phase-12 launches {json.dumps(counts)}; phase-13 launches decode host "
            f"{fleet['launches'][k.name]}, prefill host {fleet['prefill_host']['launches'][k.name]}; phase-14 "
            f"launches (the supervised full tier) {control['launches'][k.name]} [{card}]")
    for label in OCR_FLASH_SHAPES:
        row = rows[f"flash_attention ({label})"]
        log(f"kernel row flash_attention {label} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}: terms {json.dumps({k: round(v, 5) for k, v in row['bound_terms'].items()})}), plain "
            f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, max|diff| {row['max_abs_err']:.3e}, phase-10 (b) "
            f"launches {ocr['native_launches']} [{card}]")
    for label, key in (("CLIP vision", "vision (a)"), ("CLIP text, causal", "text (b)")):
        row = rows[f"flash_attention ({label})"]
        log(f"kernel row flash_attention {label} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, max|diff| "
            f"{row['max_abs_err']:.3e}, phase-8 launches {clip['launches'][key]} [{card}]")

    table = []
    for k in kernels:
        source, replaces = SOURCES[k.name]
        row = rows[k.name]
        # Launches come from phase 6, the main path: the bf16 server for the
        # bf16 path's kernels, the int8 + speculation server for the others.
        launches = grpc_drive["launches" if k.name in PHASE4_KERNELS else "launches8"][k.name]
        table.append(dict(
            name=k.name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
        ))
    # The head_dim-16 instance of flash_attention (the native OCR recognizer,
    # phase 10 (b): its launches there) at its widest call.
    row = rows[f"flash_attention ({list(OCR_FLASH_SHAPES)[-1]})"]
    source, replaces = SOURCES["flash_attention"]
    table.append(dict(
        name="flash_attention [head_dim 16]", route="cuda", source=source, replaces=replaces,
        launches=ocr["native_launches"], max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
    ))
    # The head_dim-128 instances (the Qwen2-MoE decoder) and w8a16 at its
    # shapes: launches from phase 15 (a) -- the bf16 drive for the cache and
    # paged instances, the int8 + speculation drive for the verify window
    # and w8a16, the cacheless forward for flash_attention.
    hd128_launches = {
        "flash_attention": moe["forward_launches"]["flash_attention"].get(128, 0),
        "flash_attention_cache": moe["bf16"]["instances"]["flash_attention_cache"].get(128, 0),
        "paged_attention": moe["bf16"]["instances"]["paged_attention"].get(128, 0),
        "paged_attention_varq": moe["int8"]["instances"]["paged_attention_varq"].get(128, 0),
    }
    for name, launches in hd128_launches.items():
        row = rows[f"{name} [head_dim 128]"]
        source, replaces = SOURCES[name]
        table.append(dict(
            name=f"{name} [head_dim 128]", route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    # flash_attention at a place's part of the bulk CLIP batch over {"data": 2}
    # (phase 19 (c)), with the launches of phase 19 (a)'s run over the axis.
    row = rows[f"flash_attention ({next(iter(DATA_FLASH_SHAPES))})"]
    source, replaces = SOURCES["flash_attention"]
    table.append(dict(
        name="flash_attention [CLIP over data 2, a place's part]", route="cuda", source=source, replaces=replaces,
        launches=data["launches"], max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
    ))
    row = rows["w8a16_matmul [Qwen1.5-MoE]"]
    source, replaces = SOURCES["w8a16_matmul"]
    table.append(dict(
        name="w8a16_matmul [Qwen1.5-MoE shapes]", route="cuda", source=source, replaces=replaces,
        launches=moe["int8"]["launches"]["w8a16_matmul"], max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
    ))
    # The float16 instances, with phase 23's launches by head_dim (the
    # float16 tier and the MoE decoder), and the grouped product in float16
    # and float32 (phase 23 (b)'s MoE decoder).
    def fp16_count(name: str, dt: str, inst) -> int:  # (the lane's result came through JSON: string keys)
        return fp16["launches"].get(name, {}).get(dt, {}).get(json.dumps(inst), 0)

    first = len(table)
    for name in PHASE23_FP16_KERNELS:
        for d in (16, 64, 128) if name == "flash_attention" else (64, 128):
            label = f"{name} [float16, head_dim {d}]"
            row = rows[label]
            source, replaces = SOURCES[name]
            table.append(dict(
                name=label, route="cuda", source=source, replaces=replaces, launches=fp16_count(name, "float16", d),
                max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
            ))
    for dt in PHASE23_GROUPED_DTYPES:
        row = rows[f"grouped_mm [{dt}]"]
        source, replaces = SOURCES["grouped_mm"]
        table.append(dict(
            name=f"grouped_mm [{dt}]", route="cuda", source=source, replaces=replaces,
            launches=fp16_count("grouped_mm", dt, None), max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    for entry in table[first:]:
        lib = "none" if entry["library_ms"] is None else f"{entry['library_ms']:.4f} ms"
        log(f"kernel row {entry['name']} {rows[entry['name']]['shape']}: {entry['ms']:.4f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}), plain {entry['plain_ms']:.4f} ms, library {lib}, "
            f"phase-23 launches {entry['launches']} [{card}]")
    for name, row in rows.items():
        if ("128" in name or "Qwen1.5-MoE" in name) and "float16" not in name:
            log(f"kernel row {name} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library "
                + ("none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms") + f" [{card}]")
    for name, row in rows.items():
        if "hbm_ms" in row:
            log(f"kernel row {name}: {row['ms']:.4f} ms warm, {row['hbm_ms']:.4f} ms from device memory (bound "
                f"{row['bound_ms']:.5f} ms) [{card}]")
    for shape, r in rows["w8a16_matmul [Qwen1.5-MoE]"]["shapes"].items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel row w8a16_matmul {shape}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"plain {r['plain_ms']:.4f} ms, library (_weight_int8pack_mm) {lib} [{card}]")
    log(f"{card}")
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
