// MLConfiguration.tsx (621 LoC): tabbed hyperparameter editor — one tab
// per GBDT model plus ensemble and training, parameter cards grouped by
// category with range sliders / option selects, ensemble tab with live
// weight-distribution bar and normalized percentages, model status cards,
// per-tab save with unsaved-changes indicator, reset to defaults, start
// training.
import {api, h, main, esc, fmt, pct, toast, USER} from "/static/app.js";

const TAB_META = [
  ["catboost", "🐱 CatBoost"], ["xgboost", "⚡ XGBoost"],
  ["lightgbm", "💡 LightGBM"], ["ensemble", "🎯 Ensemble"],
  ["training", "🏋️ Training"]];
const MODEL_COLOR = {catboost: "#3b82f6", xgboost: "#22c55e",
                     lightgbm: "#8b5cf6"};

export default async function MLConfiguration() {
  const [{config}, desc, mstatus] = await Promise.all([
    api("/api/ml-config"),
    api("/api/ml-config/parameter-descriptions"),
    api("/api/ml-config/models/status")]);
  const privileged = USER && ["admin", "researcher"].includes(USER.role);
  let dirty = false;

  main.append(h(`<div class="panel"><h2>ML configuration
      <span class="dim">CatBoost, XGBoost, LightGBM, ensemble and training
      settings</span>
      ${privileged ? `<button class="action" id="mlc-train">start training
        </button>
        <button class="mini" id="mlc-reset">reset to defaults</button>` : ""}
      <span class="dim" id="mlc-dirty"></span></h2>
    <div class="grid" style="grid-template-columns:repeat(3,1fr)">
      ${Object.entries(mstatus.models || mstatus)
        .filter(([slot]) => MODEL_COLOR[slot])
        .map(([slot, st]) => `<div class="panel">
        <div class="row"><span style="width:10px;height:10px;
          border-radius:50%;background:${st.file_exists ? "var(--ok)"
          : "var(--line)"}"></span><b style="color:${MODEL_COLOR[slot]}">${
          esc(slot)}</b></div>
        <div class="dim" style="font-size:12px">${st.file_exists
          ? `trained · ${st.loaded ? "loaded in runtime" : "on disk"}`
          : "not trained"}</div></div>`).join("")}</div>
    <div class="row" id="mlc-tabs" style="margin-top:8px;gap:4px;
      flex-wrap:wrap"></div>
    <div id="mlc-content" style="margin-top:8px"></div>
    ${privileged ? `<div class="row" style="margin-top:10px">
      <button class="action" id="mlc-save">save this tab</button>
      <span class="dim">persists to ml_config.json; the next training run
        uses it</span></div>`
      : `<div class="dim">read-only for raters</div>`}</div>`));

  let active = "catboost";
  const tabs = document.getElementById("mlc-tabs");
  const content = document.getElementById("mlc-content");
  const dirtyEl = document.getElementById("mlc-dirty");
  const markDirty = () => {
    dirty = true;
    dirtyEl.textContent = "· unsaved changes";
  };

  TAB_META.forEach(([k, label]) => {
    // append the BUTTON, not h()'s wrapper div — the active-tab
    // outline below reads children[i].dataset.t
    const b = h(`<button class="mini" data-t="${k}">${label}
      </button>`).querySelector("button");
    b.onclick = () => { active = k; render(); };
    tabs.append(b);
  });

  // one editable card per parameter: slider for ranged numbers, select
  // for enumerated options, checkbox for bools (tsx renderParamInput)
  const paramCard = (tab, key, value) => {
    const meta = (desc[tab] || {})[key] || {};
    const id = `mlc-${tab}-${key}`;
    let input;
    if (meta.options) {
      input = `<select data-p="${key}" id="${id}">${meta.options.map(o =>
        `<option ${o === value ? "selected" : ""}>${o}</option>`).join("")}
        </select>`;
    } else if (typeof value === "boolean") {
      input = `<label><input type="checkbox" data-p="${key}" id="${id}"
        ${value ? "checked" : ""}> enabled</label>`;
    } else if (typeof value === "number" && meta.range) {
      const [lo, hi] = meta.range;
      const step = hi - lo > 10 ? 1 : 0.01;
      input = `<div class="row">
        <input type="range" data-p="${key}" id="${id}" min="${lo}"
          max="${Math.min(hi, hi > 1000 ? 2000 : hi)}" step="${step}"
          value="${value}" style="flex:1">
        <input type="number" step="any" data-pn="${key}" value="${value}"
          style="width:86px"></div>`;
    } else if (typeof value === "object") {
      input = `<input data-p="${key}" data-json="1" id="${id}"
        value='${esc(JSON.stringify(value))}' style="width:100%">`;
    } else {
      input = `<input data-p="${key}" id="${id}" value="${esc(value)}"
        style="width:100%">`;
    }
    return `<div class="panel" style="padding:8px">
      <div class="row" style="justify-content:space-between">
        <b style="font-size:13px">${esc(meta.name || key)}</b>
        <span class="dim" style="font-size:11px">${meta.range
          ? `[${meta.range[0]}–${meta.range[1]}]` : ""}</span></div>
      ${input}
      <div class="dim" style="font-size:11px;margin-top:3px">${
        esc(meta.description || "")}</div></div>`;
  };

  const renderEnsemble = () => {
    const ens = config.ensemble || {};
    const w = ens.weights || {};
    const total = (w.catboost || 0) + (w.xgboost || 0) + (w.lightgbm || 0)
      || 1;
    return `<h3>Model weight distribution</h3>
      <div class="dim" style="font-size:12px;margin-bottom:6px">how much
        each model contributes to the ensemble prediction — weights are
        normalized automatically</div>
      <div class="row" id="mlc-wbar" style="height:28px;gap:0;
          border-radius:8px;overflow:hidden">
        ${["catboost", "xgboost", "lightgbm"].map(m => `<div
          style="width:${100 * (w[m] || 0) / total}%;background:${
          MODEL_COLOR[m]};display:flex;align-items:center;
          justify-content:center;font-size:11px;color:#fff">${m}</div>`)
          .join("")}</div>
      <div class="grid" style="grid-template-columns:repeat(3,1fr);
          margin-top:8px">
        ${["catboost", "xgboost", "lightgbm"].map(m => `<div class="panel"
            style="padding:8px;text-align:center">
          <b style="color:${MODEL_COLOR[m]}">${m}</b>
          <input type="range" min="0" max="1" step="0.01" value="${w[m] || 0}"
            data-w="${m}" style="width:100%">
          <div class="dim" data-wl="${m}">${pct((w[m] || 0) / total)}</div>
          </div>`).join("")}</div>
      <div class="grid" style="grid-template-columns:repeat(2,1fr);
          margin-top:8px">
        ${paramCard("ensemble", "voting_method", ens.voting_method || "soft")}
        ${paramCard("ensemble", "threshold", ens.threshold ?? 0.5)}</div>`;
  };

  const render = () => {
    [...tabs.children].forEach(b =>
      b.style.outline = b.dataset.t === active ? "2px solid var(--accent)"
        : "");
    if (active === "ensemble") {
      content.innerHTML = renderEnsemble();
      content.querySelectorAll("input[data-w]").forEach(sl => {
        sl.oninput = () => {
          config.ensemble.weights[sl.dataset.w] = +sl.value;
          markDirty();
          const w = config.ensemble.weights;
          const total = (w.catboost || 0) + (w.xgboost || 0) +
            (w.lightgbm || 0) || 1;
          content.querySelectorAll("[data-wl]").forEach(el =>
            el.textContent = pct((w[el.dataset.wl] || 0) / total));
          const bar = document.getElementById("mlc-wbar");
          [...bar.children].forEach((seg, i) => seg.style.width =
            `${100 * (w[["catboost", "xgboost", "lightgbm"][i]] || 0)
              / total}%`);
        };
      });
      wireParams("ensemble");
      return;
    }
    const section = config[active] || {};
    // group by category per the reference's renderModelTab
    const byCat = {};
    Object.entries(section).forEach(([k, v]) => {
      const c = ((desc[active] || {})[k] || {}).category || "Other";
      (byCat[c] = byCat[c] || []).push([k, v]);
    });
    content.innerHTML = Object.entries(byCat).map(([cat, entries]) =>
      `<h3>${esc(cat)}</h3>
       <div class="grid" style="grid-template-columns:repeat(auto-fill,
         minmax(230px,1fr))">${entries.map(([k, v]) =>
         paramCard(active, k, v)).join("")}</div>`).join("");
    wireParams(active);
  };

  function wireParams(tab) {
    content.querySelectorAll("[data-p]").forEach(inp => {
      inp.onchange = inp.oninput = () => {
        const k = inp.dataset.p;
        let v;
        if (inp.dataset.json) {
          try { v = JSON.parse(inp.value); } catch (e) { return; }
        } else if (inp.type === "checkbox") v = inp.checked;
        else if (inp.type === "range") v = +inp.value;
        else if (typeof config[tab][k] === "number") v = +inp.value;
        else v = inp.value;
        config[tab][k] = v;
        markDirty();
        // keep the paired number box in sync with its slider
        const pair = content.querySelector(`[data-pn="${k}"]`);
        if (pair && inp.type === "range") pair.value = inp.value;
      };
    });
    content.querySelectorAll("[data-pn]").forEach(inp => {
      inp.onchange = () => {
        const k = inp.dataset.pn;
        config[tab][k] = +inp.value;
        markDirty();
        const slider = content.querySelector(`[data-p="${k}"]`);
        if (slider) slider.value = inp.value;
      };
    });
  }
  render();

  const save = document.getElementById("mlc-save");
  if (save) save.onclick = async () => {
    try {
      await api(`/api/ml-config/${active}`,
                {method: "PUT", json: config[active]});
      dirty = false; dirtyEl.textContent = "";
      toast(`${active} configuration saved`);
    } catch (e) { toast(e.message, "bad"); }
  };
  const reset = document.getElementById("mlc-reset");
  if (reset) reset.onclick = async () => {
    if (!confirm("Reset ALL model configurations to defaults?")) return;
    try {
      await api("/api/ml-config/reset", {method: "POST"});
      toast("reset to defaults"); go("mlconfig");
    } catch (e) { toast(e.message, "bad"); }
  };
  const train = document.getElementById("mlc-train");
  if (train) train.onclick = async () => {
    try {
      const r = await api("/api/training/start/ml", {method: "POST"});
      toast(r.status === "started" ? "training started"
        : JSON.stringify(r));
    } catch (e) { toast(e.message, "bad"); }
  };
}
