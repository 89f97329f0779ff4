// Hardware view (reference: web-ui/src/views/Hardware): detect the TPU,
// show generation/slice/HBM/FLOPs, pick a topology preset.

import { api } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast } from "../ui.js";

export function renderHardware(root) {
  root.append(
    el("h2", { class: "view-title" }, "Hardware"),
    el("p", { class: "view-sub" }, "Detected accelerators and the topology presets they support."),
    el("div", { class: "card", id: "hw-card" }, [
      el("div", { class: "row" }, [
        el("span", { class: "spin" }, "◌"),
        " probing accelerators (runs in a subprocess; first probe can take ~30s)…",
      ]),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Environment"),
      el("div", { class: "muted", id: "env-card" }, "checking runtime stack…"),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Topology preset"),
      el("div", { class: "muted", id: "preset-hint" }, "Presets load after detection."),
      el("div", { class: "preset-grid", id: "preset-grid" }),
    ])
  );

  detect(root);
  envCheck(root);
}

async function envCheck(root) {
  const card = root.querySelector("#env-card");
  try {
    const report = await api.hardwareCheck(wizard.state.cacheDir);
    card.classList.remove("muted");
    card.replaceChildren(
      el("div", {}, [
        report.ok
          ? el("span", { class: "badge ok" }, "environment ready")
          : el("span", { class: "badge err" }, "missing requirements"),
      ]),
      el(
        "dl",
        { class: "kv" },
        report.checks
          .map((c) =>
            kv(
              (c.ok ? "✓ " : c.required ? "✗ " : "– ") + c.name,
              c.detail
            )
          )
          .flat()
      )
    );
  } catch (e) {
    card.textContent = `environment check failed: ${e.message}`;
  }
}

async function detect(root) {
  const hwCard = root.querySelector("#hw-card");
  let report, presets;
  try {
    [report, presets] = await Promise.all([api.hardwareDetect(), api.presets()]);
  } catch (e) {
    hwCard.replaceChildren(
      el("div", { class: "badge err" }, "detection failed"),
      el("p", { class: "muted" }, e.message),
      el("button", { class: "btn small", onclick: () => { root.replaceChildren(); renderHardware(root); } }, "Retry")
    );
    return;
  }
  wizard.update({ hardware: report });

  const hw = report.hardware;
  const chip = report.chip;
  hwCard.replaceChildren(
    el("h3", {}, [
      "Detected: ",
      hw.platform === "tpu"
        ? el("span", { class: "badge ok" }, `${hw.device_kind || "TPU"} ×${hw.device_count}`)
        : el("span", { class: "badge warn" }, "no TPU — CPU mode"),
    ]),
    el("dl", { class: "kv" }, [
      kv("platform", hw.platform),
      kv("device kind", hw.device_kind || "—"),
      kv("chips", hw.device_count),
      kv("generation", report.generation || "—"),
      chip ? kv("HBM / chip", `${chip.hbm_gb} GB`) : "",
      chip ? kv("peak bf16", `${chip.bf16_tflops} TFLOP/s per chip (${chip.slice_bf16_tflops} slice)`) : "",
      kv("hosts", hw.process_count),
      kv("host CPUs", hw.cpu_count),
      kv("host memory", `${hw.memory_gb} GB`),
      hw.error ? kv("probe error", hw.error) : "",
    ].flat())
  );

  const grid = root.querySelector("#preset-grid");
  const hint = root.querySelector("#preset-hint");
  const supported = new Set(report.supported_presets || []);
  hint.textContent = `Recommended for this machine: ${report.recommended_preset}`;
  if (!wizard.state.preset && report.recommended_preset) {
    wizard.update({ preset: report.recommended_preset });
  }

  for (const [name, p] of Object.entries(presets.presets)) {
    const ok = supported.has(name);
    const card = el(
      "button",
      { class: "preset-card" + (ok ? "" : " unsupported"), disabled: ok ? undefined : "1" },
      [
        el("div", { class: "preset-name" }, [
          name,
          name === report.recommended_preset ? el("span", { class: "badge accent" }, "recommended") : "",
          p.generation ? el("span", { class: "badge" }, p.generation) : "",
        ]),
        el("div", { class: "preset-desc" }, p.description),
        el(
          "div",
          { class: "preset-meta" },
          `mesh ${JSON.stringify(p.mesh_axes)} · ${p.dtype} · clip ${p.batch_size} · ` +
            `face ${p.face_batch} · ocr ${p.ocr_batch} · vlm ${p.vlm_gen_batch} · tier ≤ ${p.max_tier}`
        ),
      ]
    );
    if (ok) {
      card.onclick = () => {
        wizard.update({ preset: name, configGenerated: false });
        refreshSelection(grid);
        toast(`preset: ${name}`);
      };
    }
    card.dataset.preset = name;
    grid.append(card);
  }
  refreshSelection(grid);
}

function refreshSelection(grid) {
  for (const card of grid.children) {
    card.classList.toggle("selected", card.dataset.preset === wizard.state.preset);
  }
}

function kv(k, v) {
  return [el("dt", {}, k), el("dd", {}, String(v))];
}
